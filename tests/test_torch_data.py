"""The port's data path (``internevo_tpu_torch/data``, ``native``,
``core/trainer.py::TrainState``, ``train/pipeline.py::load_new_batch``)
against ``internevo_tpu.data`` on the CPU: packs, ``cu_seqlens``, labels and
positions of both packed datasets on the fixtures of ``tests/test_data``
(small list datasets and ``RandomDataset``), the collaters' arrays and
segment ids, the sampler streams (rampup, two data ranks, several epochs),
the sampler snapshot across an epoch rollover and the resume position, the
whole train loader and the validation loader from one config, a folder of
``.bin`` files through ``JsonlDataset``, and fastpack's native parse against
its numpy/json path.

Everything is host numpy: equal means byte for byte (same dtype, shape and
bytes)."""

import json
from types import SimpleNamespace

import numpy as np
import pytest

from internevo_tpu.data import batch_sampler as jbs
from internevo_tpu.data import collaters as jcol
from internevo_tpu.data import packed_dataset as jpd
from internevo_tpu.data.dummy_dataset import RandomDataset as JRandomDataset
from internevo_tpu_torch import native as tnative
from internevo_tpu_torch.core.config import Config
from internevo_tpu_torch.core.trainer import TrainState
from internevo_tpu_torch.data import batch_sampler as tbs
from internevo_tpu_torch.data import build_dataloader as tbuild
from internevo_tpu_torch.data import collaters as tcol
from internevo_tpu_torch.data import packed_dataset as tpd
from internevo_tpu_torch.data.dummy_dataset import RandomDataset as TRandomDataset
from internevo_tpu_torch.initialize.launch import args_sanity_check
from internevo_tpu_torch.train.pipeline import batch_to_device, load_new_batch
from tests.test_data.test_packed_dataset import ListDataset


def same(a, b, what=""):
    """Byte for byte, recursively through dicts, lists and tuples."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), what
        for k in a:
            same(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)) and not all(isinstance(x, (int, np.integer)) for x in a):
        assert type(a) is type(b) and len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{what}[{i}]")
    elif isinstance(a, (str, float)):
        assert a == b, what
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes(), what


def _list_samples(seed, n=60):
    rng = np.random.RandomState(seed)
    return [list(rng.randint(1, 500, rng.randint(1, 40))) for _ in range(n)]


DATASET_KINDS = ("list", "random_fixed", "random_varlen")


def _pair(kind):
    if kind == "list":
        samples = _list_samples(0)
        return ListDataset(samples), ListDataset(samples)
    fixed = kind == "random_fixed"
    return (JRandomDataset(num_samples=80, max_len=32, fixed_seqlen=fixed),
            TRandomDataset(num_samples=80, max_len=32, fixed_seqlen=fixed))


@pytest.mark.parametrize("fixed", [True, False], ids=["fixed", "varlen"])
def test_random_dataset_samples_equal(fixed):
    """The port builds each sample when it is read; every sample, its
    length and the token types equal the JAX dataset's, which builds them
    all up front."""
    j, t = JRandomDataset(num_samples=600, max_len=300, fixed_seqlen=fixed), \
        TRandomDataset(num_samples=600, max_len=300, fixed_seqlen=fixed)
    same(j.lengths, t.lengths, "lengths")
    assert len(j) == len(t) == 600
    for i in range(len(j)):
        a, b = j[i], t[i]
        assert a == b and [type(x) for x in a["tokens"]] == [type(x) for x in b["tokens"]], i


@pytest.mark.parametrize("kind", DATASET_KINDS)
@pytest.mark.parametrize("cls,use_packed", [("PackedDatasetWithCut", True), ("PackedDatasetWithCut", False),
                                            ("PackedDatasetWithoutCuSeqlen", True)])
def test_packs_byte_identical(kind, cls, use_packed):
    jds, tds = _pair(kind)
    same(jds.lengths, tds.lengths, "lengths")
    kw = dict(max_length_per_sample=24, packed_length=48, use_packed=use_packed, micro_bsz=2)
    jp, tp = getattr(jpd, cls)(jds, **kw), getattr(tpd, cls)(tds, **kw)
    assert len(jp) == len(tp) > 3
    for i in range(len(jp)):
        same(jp[i], tp[i], f"pack {i}")
    cat_j, cat_t = jpd.ConcatDataset([jp, jp]), tpd.ConcatDataset([tp, tp])
    assert len(cat_j) == len(cat_t)
    same(cat_j[len(jp) + 1], cat_t[len(tp) + 1], "concat")


def test_collaters_byte_identical():
    jds, tds = _pair("random_varlen")
    jp = jpd.PackedDatasetWithCut(jds, max_length_per_sample=24, packed_length=48)
    tp = tpd.PackedDatasetWithCut(tds, max_length_per_sample=24, packed_length=48)
    same(jcol.packed_collate_fn([jp[i] for i in (0, 3, 5)], packed_length=48),
         tcol.packed_collate_fn([tp[i] for i in (0, 3, 5)], packed_length=48), "packed")
    samples = [{"tokens": [5, -6, 7, 8], "type_id": 1}, {"tokens": list(range(1, 40)), "type_id": 2}]
    same(jcol.jsonl_ds_collate_fn(samples, max_length_per_sample=32),
         tcol.jsonl_ds_collate_fn(samples, max_length_per_sample=32), "jsonl")
    for cu in ([0, 3, 5, 8], [0, 8], [0, 2, 2, 7, 8]):
        same(jcol.cu_seqlens_to_segment_ids(np.array(cu), 8), tcol.cu_seqlens_to_segment_ids(np.array(cu), 8))


class _N:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n


@pytest.mark.parametrize("rampup,rank,world", [(None, 0, 1), ("2 2 3", 0, 1), ("2 2 3", 1, 2)],
                         ids=["flat", "rampup", "rampup_rank1_of_2"])
def test_sampler_streams_identical(rampup, rank, world):
    kw = dict(batch_size=8, rampup_batch_size=rampup, micro_bsz=1, seed=7, data_rank=rank, data_world_size=world)
    js, ts = jbs.StaticBatchSampler([_N(90)], **kw), tbs.StaticBatchSampler([_N(90)], **kw)
    assert len(js) == len(ts)
    for epoch in range(3):  # the pool reshuffles at the end of each epoch
        jb, tb = list(js), list(ts)
        assert len(jb) == len(tb) > 0
        for a, b in zip(jb, tb):
            same(a, b, f"epoch {epoch}")
    same(js.state_dict()["indices"], ts.state_dict()["indices"])
    dj, dt = (m.DataParallelSampler(_N(37), batch_size=4, shuffle=True, seed=3, data_rank=rank,
                                    data_world_size=world) for m in (jbs, tbs))
    assert list(map(list, dj)) == list(map(list, dt))


class _DL:
    def __init__(self, sampler):
        self.batch_sampler = sampler

    def __iter__(self):
        return (({"ids": list(b)}, list(b)) for b in iter(self.batch_sampler))


def test_sampler_snapshot_and_resume_position():
    """The ``TrainState`` snapshot across an epoch rollover inside
    ``load_new_batch`` equals JAX's state for the same loop, and a sampler
    restored from it continues the stream where the loop stopped."""
    from internevo_tpu.core.trainer import TrainState as JTrainState
    from internevo_tpu.train.pipeline import load_new_batch as jload

    cfg = SimpleNamespace(data=SimpleNamespace(total_steps=1000))
    states, streams = [], []
    for mod, state_cls, load in ((jbs, JTrainState, jload), (tbs, TrainState, load_new_batch)):
        s = mod.StaticBatchSampler([_N(40)], batch_size=8, rampup_batch_size=None, micro_bsz=1, seed=7)
        dl, ts = _DL(s), state_cls(cfg, batch_sampler=s)
        it, stream = iter(dl), []
        for _ in range(7):  # an epoch is 5 batches: the rollover happens inside load_new_batch
            batch, it = load(dl, it, ts)
            stream.append(batch[1])
        states.append(ts.state_dict())
        streams.append(stream)
        cont = [load(dl, it, ts)[0][1] for _ in range(3)]
        streams.append(cont)
    same(states[0], states[1], "state")
    assert streams[0] == streams[2] and streams[1] == streams[3]
    resumed = tbs.StaticBatchSampler([_N(40)], batch_size=8, rampup_batch_size=None, micro_bsz=1, seed=7)
    resumed.load_state_dict(states[1]["batch_sampler"])
    assert [list(b) for _, b in zip(range(3), resumed)] == streams[3]
    ts = TrainState(cfg)
    ts.load_state_dict(states[1])
    assert ts.batch_count == states[1]["batch_count"] + 1


def _loader_config(**data):
    base = dict(seq_len=32, micro_num=3, micro_bsz=2, total_steps=8, rampup_batch_size="", train_folder=None,
                num_random_samples=400, fixed_random_dataset_seqlen=True)
    return dict(data={**base, **data})


@pytest.mark.parametrize("data", [{}, dict(pack_sample_into_one=True), dict(rampup_batch_size="1 1 2")],
                         ids=["cut", "into_one", "rampup"])
def test_train_loader_byte_identical(data):
    """``RandomDataset`` through the whole loader, from one config: the JAX
    loader under a one-device launch, the port's from its own launch
    defaults."""
    import jax

    from internevo_tpu.data.build_dataloader import build_train_loader_with_data_type as jbuild
    from internevo_tpu.initialize.launch import launch as jlaunch

    jlaunch(_loader_config(**data), seed=1024, devices=jax.devices()[:1])
    jdl, jtypes = jbuild()
    tdl, ttypes = tbuild.build_train_loader_with_data_type(args_sanity_check(Config(_loader_config(**data))))
    assert jtypes == ttypes and len(jdl) == len(tdl)
    for step, (jb, tb) in zip(range(6), zip(jdl, tdl)):
        same(jb, tb, f"step {step}")
    dev = batch_to_device(tb, tb[0]["input_ids"].shape[0], "cpu")
    assert dev["input_ids"].shape == (tb[0]["input_ids"].shape[0], 1, 64) and str(dev["labels"].dtype) == "torch.int64"


def test_valid_loader_byte_identical():
    import jax

    from internevo_tpu.data.build_dataloader import build_valid_loader_with_data_type as jbuild
    from internevo_tpu.initialize.launch import launch as jlaunch

    jlaunch(_loader_config(), seed=1024, devices=jax.devices()[:1])
    (jl, jnames), (tl, tnames) = jbuild(), tbuild.build_valid_loader_with_data_type(
        args_sanity_check(Config(_loader_config())))
    assert jnames == tnames
    for name in jnames:
        for jb, tb in zip(jl[name], tl[name]):
            same(jb, tb, name)


def _bin_folder(root, seed=0):
    rng = np.random.RandomState(seed)
    folder = root / "en"
    folder.mkdir(parents=True)
    for f in range(2):
        with open(folder / f"part{f}.bin", "wb") as fh:
            for _ in range(30):
                fh.write(json.dumps({"tokens": rng.randint(-50, 1000, rng.randint(5, 90)).tolist()}).encode() + b"\n")
        tnative.prepare_meta_fast(str(folder / f"part{f}.bin"))
    return root


def test_bin_folder_packs_byte_identical(tmp_path):
    """A folder of ``.bin`` files (their ``.meta`` built by the port's
    fastpack), short samples filtered, through both packed-folder builders."""
    folder = _bin_folder(tmp_path)
    kw = dict(max_length_per_sample=64, packed_length=128, min_length=10)
    jc = jpd.get_packed_dataset_without_short_length(str(folder), **kw)
    tc = tpd.get_packed_dataset_without_short_length(str(folder), **kw)
    assert len(jc) == len(tc) > 3
    for i in range(len(jc)):
        same(jc[i], tc[i], f"pack {i}")


def test_fastpack_native_matches_numpy(tmp_path):
    """The native parse and meta builder, built into the port's ``build/``
    and not beside the source, against the JAX package's numpy/json path."""
    assert tnative.native_available()
    assert tnative.library_path().parent.name == "build" and tnative.library_path().exists()
    assert not list(tnative.SOURCE.parent.glob("*.so"))
    rng = np.random.RandomState(1)
    for n in (0, 1, 7, 500):
        line = json.dumps({"tokens": rng.randint(-100, 100000, n).tolist()}).encode()
        same(tnative.parse_tokens_line(line), tnative.python_parse_tokens_line(line))
    buf = b"".join(json.dumps({"tokens": list(range(n))}).encode() + b"\n" for n in (3, 10, 1, 250))
    same(tnative.build_meta_from_bytes(buf), tnative.python_build_meta(buf))
    folder = _bin_folder(tmp_path / "x")
    path = folder / "en" / "part0.bin"
    from internevo_tpu.data.single_dataset import JsonlDataset as JJsonl
    from internevo_tpu_torch.data.single_dataset import JsonlDataset as TJsonl

    jd, td = JJsonl(str(path), 0, min_length=10), TJsonl(str(path), 0, min_length=10)
    assert len(jd) == len(td) > 0
    for i in range(len(jd)):
        same(jd[i], td[i], f"sample {i}")
