"""Monitoring and alerts (port of ``internevo_tpu/monitor/monitor.py``;
reference ``internlm/monitor/monitor.py`` and ``monitor/alert.py``).

``MonitorTracker`` is a thread that checks, every ``check_interval``
seconds, that the loop is still advancing and that the loss did not spike;
``initialize_monitor_manager`` runs it around the training loop when an
alert address is configured; ``send_alert_message`` posts a Feishu webhook
message to that address through ``urllib`` and logs the alert without one.
A failed post is logged and dropped: an alert never stops training.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
import urllib.request
from typing import Optional

from ..utils.logger import get_logger

logger = get_logger(__name__)

LAST_ACTIVE_TIMESTAMP = "LAST_ACTIVE_TIMESTAMP"


def set_env_var(key: str, value):
    os.environ[str(key)] = str(value)


def send_feishu_msg_with_webhook(webhook: str, title: str, message: str) -> bool:
    """POST a Feishu "post" message (reference ``monitor/alert.py``); True
    when the webhook accepted it."""
    body = {"msg_type": "post",
            "content": {"post": {"zh_cn": {"title": title, "content": [[{"tag": "text", "text": message}]]}}}}
    request = urllib.request.Request(webhook, data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(request, timeout=10) as response:
            return 200 <= response.status < 300
    except OSError as e:  # URLError, HTTPError and timeouts are all OSErrors
        logger.warning("alert to %s failed: %s (%s: %s)", webhook, e, title, message)
        return False


_HEARTBEAT_EVERY = 50  # steps (reference light-monitor cadence, monitor/alert.py:16-90)
_last_heartbeat_step = -1


def send_heartbeat(msg_type: str, info: dict, step: Optional[int] = None, every: int = _HEARTBEAT_EVERY) -> bool:
    """Light-monitor heartbeat (reference ``monitor/alert.py:16-90``): the
    {job, type, info} payload goes to the log every ``every`` steps; True
    when one fired."""
    global _last_heartbeat_step
    if step is not None:
        if step % every != 0 or step == _last_heartbeat_step:
            return False
        _last_heartbeat_step = step
    payload = {"job_name": os.environ.get("JOB_NAME", "internevo_tpu"), "msg_type": msg_type, "step": step,
               **info}
    logger.info("heartbeat %s", payload)
    return True


def send_alert_message(address: Optional[str] = None, title: str = "internevo_tpu", message: str = ""):
    if address:
        send_feishu_msg_with_webhook(address, title, message)
    else:
        logger.warning("[ALERT] %s: %s", title, message)


class MonitorTracker(threading.Thread):
    """Every ``check_interval`` seconds: (a) has the loop advanced
    LAST_ACTIVE_TIMESTAMP, (b) did the loss rise above ``loss_spike_limit``
    times the previous reading (reference :35-126)."""

    def __init__(self, alert_address: Optional[str], check_interval: float = 300,
                 loss_spike_limit: float = 1.5):
        super().__init__(daemon=True)
        self.alert_address = alert_address
        self.check_interval = check_interval
        self.loss_spike_limit = loss_spike_limit
        self.last_active_time = -1
        self.last_loss_value = -1.0
        self.current_loss = None
        self.current_step = 0
        self._stop_event = threading.Event()

    def update(self, loss: float, step: int):
        self.current_loss = loss
        self.current_step = step
        set_env_var(LAST_ACTIVE_TIMESTAMP, int(time.time()))

    def run(self):
        while not self._stop_event.wait(self.check_interval):
            self._check_stuck()
            self._check_loss_spike()

    def _check_stuck(self):
        new_active_time = int(os.getenv(LAST_ACTIVE_TIMESTAMP, -1))
        if new_active_time <= 0 or self.last_active_time == new_active_time:
            send_alert_message(self.alert_address, message="training may be in stuck status, please check it.")
        self.last_active_time = new_active_time

    def _check_loss_spike(self):
        if self.current_loss is None:
            return
        if self.last_loss_value > 0 and self.current_loss > self.loss_spike_limit * self.last_loss_value:
            send_alert_message(
                self.alert_address,
                message=f"loss spike may be happened in step {self.current_step}, "
                        f"loss value from {self.last_loss_value} to {self.current_loss}",
            )
        self.last_loss_value = self.current_loss

    def stop(self):
        self._stop_event.set()


class MonitorManager:
    def __init__(self, loss_spike_limit: float = 1.5):
        self.loss_spike_limit = loss_spike_limit
        self.monitor_thread: Optional[MonitorTracker] = None

    def start_monitor(self, job_name: str, alert_address: Optional[str], monitor_interval_seconds: float = 300):
        if alert_address is None:
            return
        self.monitor_thread = MonitorTracker(alert_address, monitor_interval_seconds, self.loss_spike_limit)
        self.monitor_thread.start()

    def update(self, loss: float, step: int):
        """The loop's reading of one settled step, for the tracker's checks."""
        if self.monitor_thread is not None:
            self.monitor_thread.update(loss, step)

    def stop_monitor(self):
        if self.monitor_thread is not None:
            self.monitor_thread.stop()
            self.monitor_thread.join(timeout=5)
            self.monitor_thread = None


monitor_manager = MonitorManager()


@contextlib.contextmanager
def initialize_monitor_manager(job_name: str = "job", alert_address: Optional[str] = None):
    if alert_address is not None:
        monitor_manager.start_monitor(job_name=job_name, alert_address=alert_address)
        send_alert_message(alert_address, message=f"training job {job_name} started")
    try:
        yield
    finally:
        if alert_address is not None:
            send_alert_message(alert_address, message=f"training job {job_name} completed")
            monitor_manager.stop_monitor()
