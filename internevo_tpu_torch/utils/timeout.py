"""Phase timeouts (a copy of ``internevo_tpu/utils/timeout.py``, which
imports no JAX; reference ``internlm/utils/timeout.py:13-113``).

``llm_timeout`` raises ``LlmTimeoutError`` through SIGALRM when a phase
outlasts its budget, so a hang surfaces as an exception.  It does nothing
unless ``IEVO_ENABLE_TIMEOUT`` is set when this module is imported.
"""

from __future__ import annotations

import functools
import os
import signal

ENABLE_TIMEOUT = os.getenv("IEVO_ENABLE_TIMEOUT", None) is not None

# seconds per phase (reference timeout table)
LLM_TIMEOUT_DICTS = {
    "initialize_distributed_env": 120,
    "nopp_forward_backward_step": 360,
    "initialize_model": 600,
    "initialize_optimizer": 60,
    "optim_step": 60,
    "get_train_data_loader": 600,
    "get_validation_data_loader": 60,
    "load_new_batch": 120,
    "record_current_batch_training_metrics": 60,
    "save_checkpoint": 1200,
    "interleaved_forward_backward_step": 600,
    "nointerleaved_forward_backward_step": 600,
}


class LlmTimeoutError(TimeoutError):
    pass


def llm_timeout(seconds: int = 0, func_name: str | None = None):
    """Decorator: raise LlmTimeoutError if the call exceeds the budget (the
    table's entry for the function's name, else ``seconds``)."""

    def decorator(func):
        name = func_name or func.__name__
        budget = LLM_TIMEOUT_DICTS.get(name, seconds) or seconds

        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            if not ENABLE_TIMEOUT or budget <= 0:
                return func(*args, **kwargs)

            def _handler(signum, frame):
                raise LlmTimeoutError(f"{name} timed out after {budget}s")

            old = signal.signal(signal.SIGALRM, _handler)
            signal.alarm(int(budget))
            try:
                return func(*args, **kwargs)
            finally:
                signal.alarm(0)
                signal.signal(signal.SIGALRM, old)

        return wrapper

    return decorator
