"""The saves' pinned staging buffers are allocated at set-up, before the
loop's first step, and every save copies into those same buffers: the first
save allocates nothing, so it holds the loop no longer than a later one.

On the CPU the state is cloned, not staged; the test makes the manager stage
CPU state as it stages CUDA state (``staged_on_host`` true, plain host
tensors for ``pinned_like``, no stream to synchronise) and runs the entry
point's loop on ``tests/test_training/test_loss.py::demo_config()`` with two
saves."""

import pytest
import torch

from internevo_tpu_torch.checkpoint import checkpoint_manager as ckpt
from internevo_tpu_torch.solver.optimizer import tree_leaves
from internevo_tpu_torch.train import main as tmain
from tests.test_training import test_loss


class _Stream:
    def synchronize(self):
        pass


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the loop runs many tiny ops, and with the suite's
    parallel workers sharing the cores an op's thread barrier costs more than
    the op (as ``test_torch_entry.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cpu_staging(monkeypatch):
    """Stage CPU state as CUDA state is staged, and count the allocations."""
    allocated = []

    def pinned_like(tree):
        out = ckpt.tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype), tree)
        allocated.extend(id(t) for t in tree_leaves(out))
        return out

    monkeypatch.setattr(ckpt, "staged_on_host", lambda leaves: bool(leaves))
    monkeypatch.setattr(ckpt, "pinned_like", pinned_like)
    monkeypatch.setattr(ckpt.torch.cuda, "current_stream", lambda device=None: _Stream())
    return allocated


def test_first_save_allocates_nothing(cpu_staging, monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    snapshots = []  # (ids of the staged leaves before the snapshot, after it, allocations so far)
    snapshot = ckpt.snapshot_to_host

    def recorded(tree, staged=None):
        before = len(cpu_staging)
        out = snapshot(tree, staged)
        snapshots.append(([id(t) for t in tree_leaves(staged)] if staged is not None else None,
                          [id(t) for t in tree_leaves(out)], len(cpu_staging) - before))
        return out

    monkeypatch.setattr(ckpt, "snapshot_to_host", recorded)
    cfg = test_loss.demo_config(ckpt=dict(enable_save_ckpt=True, save_ckpt_folder=f"local:{tmp_path}/ck",
                                          checkpoint_every=2, async_upload=False), enable_tb=False)
    out = tmain.run_training(cfg, device="cpu", steps=4)
    manager = out["ckpt_manager"]
    assert out["saved_after"] == [1, 3] and len(manager.save_records) == 2
    trees = len(manager._trees())
    assert len(snapshots) == 2 * trees  # every tree, at each of the two saves
    staged_at_setup = set(cpu_staging)
    assert staged_at_setup and out["staging_s"] >= 0
    for before, after, new in snapshots:
        assert new == 0, "a save allocated staging buffers"
        assert before == after and set(after) <= staged_at_setup
    assert {i for _, after, _ in snapshots for i in after} == staged_at_setup


def test_no_staging_without_saving(cpu_staging, monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    out = tmain.run_training(test_loss.demo_config(enable_tb=False), device="cpu", steps=1)
    assert not cpu_staging and not out["ckpt_manager"]._staged
