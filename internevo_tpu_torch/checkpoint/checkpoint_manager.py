"""Checkpoint manager: periodic and snapshot saves, the stop file, auto-resume
(port of ``internevo_tpu/checkpoint/checkpoint_manager.py``; reference
``internlm/checkpoint/checkpoint_manager.py``).

The decisions are JAX's: a save every ``checkpoint_every`` steps, snapshots
every ``oss_snapshot_freq`` steps into two alternating slots, the stop file
(``+N`` saves and quits at step N, ``-N`` saves only), auto-resume from the
folder whose ``<step>.step`` stamp names the highest step, and a selective
load through ``CheckpointLoadMask``.

The folder layout is JAX's, with the arrays written by ``torch.save`` in
place of orbax:

    <folder>/arrays_model/params.pt    the params tree (the port's layout)
    <folder>/arrays_opt/<key>.pt       one file per optimizer-state key
                                       (master, m, v, step, grad_scale, ...)
    <folder>/context.pkl               train_state, lr_scheduler, model_config
    <folder>/<step>.step               written last: the folder is complete

Saving with ``async_upload`` returns once the state is snapshotted: every
leaf is copied to host memory (pinned buffers for CUDA state, allocated at
the first save and reused), and the copy is complete before the call
returns, because the train step updates params, masters and moments in
place.  The files are then written on background threads, and the stamp
only after they land.  The next save, or ``wait_async_upload_finish``,
waits for the write and raises its error.

A load copies each leaf into the engine's live tensor, on the engine's
device, after checking that every leaf of the checkpoint matches the live
tree in path, shape and dtype; a mismatch raises and names the leaf, and
nothing is copied.  The files are memory-mapped on the host rather than
loaded onto the card, so a resume never holds two copies of the state there.
"""

from __future__ import annotations

import concurrent.futures
import hashlib
import os
import pickle
import re
import shutil
import tempfile
import time
from pathlib import Path
from typing import Optional

import torch

from ..solver.optimizer import tree_leaves, tree_leaves_with_path, tree_map
from ..utils.logger import get_logger
from ..utils.storage_manager import StorageManager, get_storage_manager, init_storage_manager

logger = get_logger(__name__)

CKPT_SLOT_COUNT = 2  # alternating snapshot slots (ref :414)
MODEL_FOLDER, OPT_FOLDER, CONTEXT_FILE = "arrays_model", "arrays_opt", "context.pkl"
PARAMS_FILE = "params.pt"
WRITE_THREADS = 4


def _best_stamped_dir(stamped) -> Optional[str]:
    """Newest '.step'-stamped directory from (filename, dir) pairs — the
    shared reducer behind the local os.walk scan and the remote key scan."""
    best_step, best_dir = -1, None
    for fn, d in stamped:
        if not fn.endswith(".step"):
            continue
        try:
            step = int(fn[: -len(".step")])
        except ValueError:
            continue
        if step > best_step:
            best_step, best_dir = step, d
    return best_dir


class CheckpointLoadMask:
    """Which components to restore (ref :166-198); content like
    ("model", "sampler", "optimizer", "scheduler", "all")."""

    LOAD_CONTENT = ("model", "sampler", "optimizer", "scheduler")

    def __init__(self, content: tuple):
        self.load_set = set(map(str.lower, content))
        if "all" in self.load_set:
            self.load_set = set(self.LOAD_CONTENT)

    def need_load(self, content: str) -> bool:
        return content.lower() in self.load_set

    def not_only_load(self, content: str) -> bool:
        return content in self.load_set and len(self.load_set) > 1

    def only_load(self, content: str) -> bool:
        return {content} == self.load_set

    def __str__(self):
        return f"{self.load_set}"


# ------------------------------------------------------------------- trees


def staged_on_host(leaves) -> bool:
    """Whether a tree of these leaves is snapshotted into pinned staging
    buffers: CUDA state is; CPU state is cloned."""
    return bool(leaves) and leaves[0].device.type == "cuda"


def pinned_like(tree):
    """A tree of pinned host tensors of ``tree``'s layout: the staging
    buffers ``snapshot_to_host`` copies CUDA leaves into."""
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, pin_memory=True), tree)


def snapshot_to_host(tree, staged=None):
    """A host copy of every leaf, complete when this returns.  CPU leaves are
    cloned.  CUDA leaves are copied into ``staged`` (a tree of pinned host
    tensors of the same layout, allocated when None or of another layout)
    and the stream is synchronised: a copy into pinned memory runs at the
    bus's rate where a fresh pageable copy faults in every page first.
    Returns the host tree (``staged`` itself for CUDA leaves)."""
    leaves = tree_leaves(tree)
    if not staged_on_host(leaves):
        return tree_map(lambda t: t.detach().to("cpu", copy=True), tree)
    if staged is None or [(t.shape, t.dtype) for t in tree_leaves(staged)] != [(t.shape, t.dtype) for t in leaves]:
        staged = pinned_like(tree)
    for dst, src in zip(tree_leaves(staged), leaves):
        dst.copy_(src.detach(), non_blocking=True)
    torch.cuda.current_stream(leaves[0].device).synchronize()
    return staged


def _read_tree(path: str):
    return torch.load(path, map_location="cpu", mmap=True, weights_only=True)


def _matched_leaves(live, loaded, where: str, cast: bool = False) -> list:
    """(live leaf, loaded leaf) pairs, after checking that the two trees hold
    the same leaves with the same shapes and, unless ``cast``, dtypes."""
    have, got = dict(tree_leaves_with_path(live)), dict(tree_leaves_with_path(loaded))
    if have.keys() != got.keys():
        missing, extra = sorted(have.keys() - got.keys()), sorted(got.keys() - have.keys())
        raise ValueError(f"checkpoint {where} does not match the live tree: missing leaves {missing[:5]}, "
                         f"unexpected leaves {extra[:5]}")
    pairs = []
    for path, t in have.items():
        src = got[path]
        if tuple(src.shape) != tuple(t.shape) or (not cast and src.dtype != t.dtype):
            raise ValueError(f"checkpoint leaf {where}{path} is {src.dtype} {tuple(src.shape)}, the live "
                             f"tree's is {t.dtype} {tuple(t.shape)}")
        pairs.append((t, src))
    return pairs


@torch.no_grad()
def _copy_pairs(pairs: list) -> None:
    for dst, src in pairs:
        dst.copy_(src)


def assign_tree(live, loaded, where: str = "", cast: bool = False) -> None:
    """Copy ``loaded`` into the live tensors of ``live`` (checked first, so a
    mismatch copies nothing); ``cast`` converts each leaf to the live dtype."""
    _copy_pairs(_matched_leaves(live, loaded, where, cast))


@torch.no_grad()
def reload_zero_fp32_buff(engine) -> None:
    """After a load of the model alone, start the optimizer afresh from the
    loaded params: fp32 masters copied from them (reference
    ``reload_zero_fp32_buff``), moments zero.  Without this the first step
    would update the masters of the random init and overwrite the loaded
    params with them."""
    state = engine.opt_state
    _copy_pairs([(m, p) for (_, m), (_, p) in zip(tree_leaves_with_path(state["master"]),
                                                   tree_leaves_with_path(engine.params))])
    for key in ("m", "v"):
        for _, t in tree_leaves_with_path(state[key]):
            t.zero_()


# ---------------------------------------------------------------- loading


def try_load_internevo_ckpt(engine, train_state, ckpt_path: str, load_mask: CheckpointLoadMask):
    """Load a checkpoint folder of this format into the engine and
    train_state.  Object-store URIs (``boto3:s3://…`` etc.) are fetched into
    a local staging folder first, which is removed after the load."""
    backend, rest = StorageManager._parse(ckpt_path)
    staging = None
    if backend != "local":
        staging = tempfile.mkdtemp(prefix="ievo_ckpt_dl_")
        ckpt_path = get_storage_manager().download_dir(ckpt_path, staging)
    else:
        ckpt_path = rest
    try:
        return _load_internevo_tree(engine, train_state, ckpt_path, load_mask)
    finally:
        if staging is not None:
            shutil.rmtree(staging, ignore_errors=True)


def _load_internevo_tree(engine, train_state, ckpt_path: str, load_mask: CheckpointLoadMask):
    path = Path(ckpt_path)
    pairs = []
    if load_mask.need_load("model"):
        pairs += _matched_leaves(engine.params, _read_tree(str(path / MODEL_FOLDER / PARAMS_FILE)), "params")
    if load_mask.need_load("optimizer"):
        opt_dir = path / OPT_FOLDER
        files = {f[: -len(".pt")] for f in os.listdir(opt_dir) if f.endswith(".pt")}
        if files != set(engine.opt_state):
            raise ValueError(f"checkpoint {opt_dir} holds optimizer state {sorted(files)}, the live state "
                             f"{sorted(engine.opt_state)}")
        for key in sorted(files):
            pairs += _matched_leaves(engine.opt_state[key], _read_tree(str(opt_dir / f"{key}.pt")),
                                     f"opt_state['{key}']")
    _copy_pairs(pairs)
    if load_mask.need_load("model") and not load_mask.need_load("optimizer"):
        reload_zero_fp32_buff(engine)
    meta_file = path / CONTEXT_FILE
    if meta_file.exists():
        with open(meta_file, "rb") as f:
            meta = pickle.load(f)
        if load_mask.need_load("sampler") and train_state is not None:
            train_state.load_state_dict(meta["train_state"], train_dl=getattr(engine, "_train_dl", None))
        if load_mask.need_load("scheduler") and "lr_scheduler" in meta:
            engine.lr_scheduler.load_state_dict(meta["lr_scheduler"])
    return True


LOAD_FUNC_DICT = {
    "internevo": try_load_internevo_ckpt,
}


def register_load_func(name: str, fn):
    LOAD_FUNC_DICT[name] = fn


# ---------------------------------------------------------------- manager


class CheckpointManager:
    def __init__(self, ckpt_config, engine=None, train_state=None, train_dl=None, model_config=None):
        self.ckpt_config = ckpt_config
        self.enable_save_ckpt = ckpt_config.get("enable_save_ckpt", False)
        self.checkpoint_every = ckpt_config.get("checkpoint_every", 50) or float("inf")
        if self.checkpoint_every <= 0:
            self.checkpoint_every = float("inf")
        self.save_ckpt_folder = ckpt_config.get("save_ckpt_folder", None)
        self.oss_snapshot_freq = ckpt_config.get("oss_snapshot_freq", 0) or 0
        self.stop_file_path = ckpt_config.get("stop_file_path", None)
        self.async_save = bool(ckpt_config.get("async_upload", True))
        self.load_ckpt_info = ckpt_config.get("load_ckpt_info", None)
        self.auto_resume = ckpt_config.get("auto_resume", True)
        self.engine = engine
        self.train_state = train_state
        self.train_dl = train_dl
        if engine is not None:
            engine._train_dl = train_dl
        self.model_config = model_config
        init_storage_manager(
            enable_save=self.enable_save_ckpt,
            async_upload=ckpt_config.get("async_upload", True),
            async_upload_tmp_folder=ckpt_config.get("async_upload_tmp_folder", None),
        )
        # one thread finishes a save (write, stamp) while the loop runs on;
        # it writes the files on a small pool, in parallel
        self._finisher: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._file_pool: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._pending: Optional[tuple] = None
        # pinned host trees the snapshots of CUDA state are copied into, kept
        # from one save to the next (a save starts after the last one landed);
        # allocated before the loop by ``allocate_staging``
        self._staged: dict = {}
        self.save_records: list[dict] = []  # one a save: path, step, seconds, bytes
        self.load_record: Optional[dict] = None

    # ------------------------------------------------------------------ saving

    def _save_path(self, step: int, snapshot_slot: Optional[int] = None) -> str:
        base = self.save_ckpt_folder
        if snapshot_slot is None:
            return os.path.join(base, str(step))
        return os.path.join(base, "snapshot", str(snapshot_slot))

    def _pools(self):
        if self._file_pool is None:
            self._file_pool = concurrent.futures.ThreadPoolExecutor(WRITE_THREADS, thread_name_prefix="ckpt-write")
            self._finisher = concurrent.futures.ThreadPoolExecutor(1, thread_name_prefix="ckpt-finish")
        return self._finisher, self._file_pool

    def _finalize_pending_save(self):
        """Barrier: wait for the save in flight; its error raises here."""
        if self._pending is None:
            return
        future, record = self._pending
        self._pending = None
        future.result()
        logger.info("checkpoint %s finalized (%.2fs since snapshot)", record["path"], record["stamp_s"])

    @staticmethod
    def _staging_dir(uri: str) -> str:
        """Deterministic, collision-free local staging dir for a remote
        checkpoint URI (a URI hash tells apart URIs whose slugs agree)."""
        safe = re.sub(r"[^A-Za-z0-9_.-]+", "_", uri)[-80:]
        tag = hashlib.md5(uri.encode()).hexdigest()[:8]
        return os.path.join(get_storage_manager().tmp_folder, "ckpt_stage", f"{safe}.{tag}")

    def _write(self, local: str, files: list, step: int, remote: Optional[str], t0: float, record: dict):
        """Write the snapshotted trees, then the stamp: the folder is complete
        only once its stamp exists.  A remote folder is uploaded whole from
        its staging folder before the stamp is put in the store."""

        def write_one(item) -> int:
            rel, tree = item
            fp = os.path.join(local, rel)
            os.makedirs(os.path.dirname(fp), exist_ok=True)
            torch.save(tree, fp)
            return os.path.getsize(fp)

        _, pool = self._pools()
        record["bytes"] += sum(pool.map(write_one, files))
        if remote is not None:
            sm = get_storage_manager()
            sm.delete_obj(remote)  # replace any previous tree (snapshot slots)
            sm.upload_dir(local, remote)
            sm.put_text(remote.rstrip("/") + f"/{step}.step", str(step))
            shutil.rmtree(local, ignore_errors=True)
        else:
            with open(os.path.join(local, f"{step}.step"), "w") as f:
                f.write(str(step))
        record["stamp_s"] = time.perf_counter() - t0

    def _trees(self) -> dict:
        """The trees a save writes, by their file in the checkpoint folder."""
        return {os.path.join(MODEL_FOLDER, PARAMS_FILE): self.engine.params,
                **{os.path.join(OPT_FOLDER, f"{key}.pt"): value for key, value in self.engine.opt_state.items()}}

    def allocate_staging(self) -> float:
        """Allocates the pinned host buffers of every CUDA tree a save
        snapshots, so that no save pays for them inside the loop.  Nothing
        happens when saving is off or the state lies on the CPU.  Returns the
        seconds it took."""
        t0 = time.perf_counter()
        if self.enable_save_ckpt:
            for rel, tree in self._trees().items():
                if staged_on_host(tree_leaves(tree)) and rel not in self._staged:
                    self._staged[rel] = pinned_like(tree)
        return time.perf_counter() - t0

    def save_checkpoint(self, path: str, train_state=None, block: bool = True):
        t0 = time.perf_counter()
        backend, rest = StorageManager._parse(path)
        remote = path if backend != "local" else None
        local = self._staging_dir(path) if remote else rest
        self._finalize_pending_save()  # the previous save lands before this one starts
        if os.path.exists(local):
            shutil.rmtree(local)
        os.makedirs(local, exist_ok=True)
        train_state = train_state or self.train_state
        for rel, tree in self._trees().items():
            self._staged[rel] = snapshot_to_host(tree, self._staged.get(rel))
        files = list(self._staged.items())
        snapshot_s = time.perf_counter() - t0
        meta = {
            "train_state": train_state.state_dict(),
            "lr_scheduler": self.engine.lr_scheduler.state_dict(),
            "model_config": dict(self.model_config) if self.model_config else None,
        }
        with open(os.path.join(local, CONTEXT_FILE), "wb") as f:
            pickle.dump(meta, f)
        step = train_state.step_count
        record = {"path": remote or local, "step": step, "snapshot_s": snapshot_s,
                  "bytes": os.path.getsize(os.path.join(local, CONTEXT_FILE)), "stamp_s": None}
        self.save_records.append(record)
        if block:
            self._write(local, files, step, remote, t0, record)
        else:
            finisher, _ = self._pools()
            self._pending = (finisher.submit(self._write, local, files, step, remote, t0, record), record)
        logger.info("saved checkpoint to %s (snapshot %.2fs%s)", remote or local, snapshot_s,
                    "" if block else ", files finishing in the background")

    def try_save_checkpoint(self, train_state) -> bool:
        """Returns True if training should stop (stop-file save-and-quit)."""
        if not self.enable_save_ckpt:
            return False
        save_ckpts, save_type, now_break = self._decide(train_state)
        if save_ckpts:
            if save_type == "snapshot":
                slot = (train_state.step_count // max(1, self.oss_snapshot_freq)) % CKPT_SLOT_COUNT
                path = self._save_path(train_state.step_count, snapshot_slot=slot)
            else:
                path = self._save_path(train_state.step_count)
            self.save_checkpoint(path, train_state, block=not self.async_save)
        return now_break

    def _decide(self, train_state):
        step = train_state.step_count
        save, save_type, now_break = False, "normal", False
        if self.oss_snapshot_freq > 0 and step % self.oss_snapshot_freq == 0 and step > 0:
            save, save_type = True, "snapshot"
        if step % self.checkpoint_every == 0 and step > 0:
            save, save_type = True, "normal"
        sf_save, sf_quit = self._query_stop_file(step)
        if sf_save:
            save, save_type = True, "normal"
            now_break = sf_quit
        return save, save_type, now_break

    def _query_stop_file(self, step: int):
        """Stop-file protocol (ref quit_signal_handler :331-403): the file
        holds -N (save at step N) or +N (save at step N AND quit); fires only
        when step == abs(N)."""
        if not self.stop_file_path or not os.path.exists(self.stop_file_path):
            return False, False
        try:
            with open(self.stop_file_path) as f:
                content = f.read().strip()
            if not content:
                return False, False
            val = int(content)
        except (ValueError, OSError):
            return False, False
        target, quit_after = abs(val), val > 0
        if target != 0 and step == target:
            return True, quit_after
        return False, False

    def wait_async_upload_finish(self):
        """Wait for the save in flight and the storage manager's uploads,
        stop the writer threads and free the host snapshot."""
        try:
            self._finalize_pending_save()
            get_storage_manager().wait()
        finally:
            for pool in (self._finisher, self._file_pool):
                if pool is not None:
                    pool.shutdown(wait=True)
            self._finisher = self._file_pool = None
            self._staged = {}

    # ----------------------------------------------------------------- loading

    def query_latest_snapshot_step_local(self) -> Optional[str]:
        """The folder under ``save_ckpt_folder`` whose ``.step`` stamp names
        the highest step (ref :438-535).  An object-store folder scans the
        store's listing; the path keeps its URI prefix."""
        folder = self.save_ckpt_folder
        if not folder:
            return None
        backend, rest = StorageManager._parse(folder)
        if backend != "local":
            return self._query_latest_remote(folder)
        if not os.path.isdir(rest):
            return None
        return _best_stamped_dir((fn, root) for root, _dirs, files in os.walk(rest) for fn in files)

    def _query_latest_remote(self, folder: str) -> Optional[str]:
        # not exception-guarded: a misconfigured store must fail auto-resume
        # loudly, not restart from step 0 and overwrite checkpoints
        keys = get_storage_manager().walk(folder)
        base = folder.rstrip("/")
        return _best_stamped_dir(
            (os.path.basename(key), base + (f"/{os.path.dirname(key)}" if os.path.dirname(key) else ""))
            for key in keys)

    def checkpoint_to_load(self) -> Optional[dict]:
        """The load ``try_resume_training`` would make: the newest stamped
        folder under ``save_ckpt_folder`` with ``auto_resume``, else
        ``load_ckpt_info``.  A ``local:`` path that does not exist holds
        nothing to load (None): the run starts fresh where JAX's loader
        would fail."""
        load_info = self.load_ckpt_info
        if self.auto_resume:
            latest = self.query_latest_snapshot_step_local()
            if latest is not None:
                return dict(path=latest, content=("all",), ckpt_type="internevo")
        if not load_info or not load_info.get("path"):
            return None
        backend, rest = StorageManager._parse(load_info["path"])
        if backend == "local" and not os.path.exists(rest):
            logger.info("no checkpoint at %s: starting fresh", load_info["path"])
            return None
        return load_info

    def try_resume_training(self, train_state, current_time: str = ""):
        load_info = self.checkpoint_to_load()
        if load_info is None:
            return
        t0 = time.perf_counter()
        content = CheckpointLoadMask(tuple(load_info.get("content", ("all",))))
        ckpt_type = load_info.get("ckpt_type", "internevo")
        if ckpt_type not in LOAD_FUNC_DICT:
            # the external loaders ('hf_llama', 'llama') register when the
            # converter module is imported (lazily: it imports this one)
            from . import convert  # noqa: F401
        load_fn = LOAD_FUNC_DICT[ckpt_type]
        load_fn(self.engine, train_state, load_info["path"], content)
        self.engine.reset_step_count()
        self.load_record = {"path": load_info["path"], "type": ckpt_type, "content": sorted(content.load_set),
                            "load_s": time.perf_counter() - t0}
        logger.info("resumed from %s (type=%s, content=%s) in %.2fs", load_info["path"], ckpt_type, content,
                    self.load_record["load_s"])
