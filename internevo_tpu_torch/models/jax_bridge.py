"""Weight bridge between the JAX parameter tree and the port's layout.

JAX tree (``internevo_tpu/models/base.py:171-229``): block leaves stacked on a
leading layer axis, dense kernels (in, out), head kernel (hidden, vocab), or
(hidden, 1) for a reward model.  The port: a list of per-layer dicts,
``torch.nn.Linear`` weights (out, in) under "weight", head weight (vocab,
hidden), or (1, hidden).  The MoE subtree ``blocks["moe"]``
(gate, expert stacks, residual coefficient) keeps the JAX layout, only
unstacked per layer: the grouped-matmul kernel takes the experts as (E, K, N),
and a transpose per call would copy them.  Every transpose and unstacking
between the two lives here.  Gradients share the param layout; optimizer
states map their master/m/v trees the same way.  Leaves keep their dtype: bf16
arrays (``ml_dtypes`` bfloat16, which ``torch.from_numpy`` rejects) travel
through float32, which holds every bf16 value exactly.

The functions that make tensors put them on the card unless the caller asks
for the CPU (``device="cpu"``, as the tests do), and raise without a card.
"""

from __future__ import annotations

import numpy as np
import torch

from ..accelerator import get_device

_LINEARS = ("wqkv", "out_proj", "w1", "w2", "w3")


def _to_torch(a, device) -> torch.Tensor:
    """A contiguous copy (the port's train step updates params in place, so a
    tensor must not share memory with the array it came from, and the fused
    AdamW update takes contiguous leaves)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32, order="C")).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a, order="C")).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # only needed to hand bf16 back to JAX

        return t.float().numpy().astype(ml_dtypes.bfloat16)
    return t.numpy()


def _layer_of(tree, i: int, device):
    """Layer ``i`` of a stacked subtree, in the same layout."""
    if isinstance(tree, dict):
        return {k: _layer_of(v, i, device) for k, v in tree.items()}
    return _to_torch(np.asarray(tree)[i], device)


def _stack(trees: list):
    """The per-layer subtrees stacked back on a leading layer axis."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack([_to_numpy(t) for t in trees])


def params_from_jax(tree: dict, device="cuda") -> dict:
    """JAX param tree (numpy or jax arrays) -> the port's params on ``device``."""
    device = get_device(device)
    blocks = tree["blocks"]
    n_layers = int(np.asarray(blocks["norm1"]).shape[0])
    layers = []
    for i in range(n_layers):
        layer = {}
        for name, leaf in blocks.items():
            if name in _LINEARS:
                layer[name] = {"weight": _to_torch(np.asarray(leaf["kernel"])[i].T, device)}
                if "bias" in leaf:
                    layer[name]["bias"] = _to_torch(np.asarray(leaf["bias"])[i], device)
            else:
                layer[name] = _layer_of(leaf, i, device)
        layers.append(layer)
    params = {
        "embedding": {"weight": _to_torch(tree["embedding"]["weight"], device)},
        "blocks": layers,
        "norm": _to_torch(tree["norm"], device),
        "head": {"weight": _to_torch(np.asarray(tree["head"]["kernel"]).T, device)},
    }
    if "norm_bias" in tree:
        params["norm_bias"] = _to_torch(tree["norm_bias"], device)
    return params


def params_to_numpy(params: dict) -> dict:
    """The port's params -> the JAX tree layout as numpy arrays."""
    layers = params["blocks"]
    blocks = {}
    for name in layers[0]:
        if name in _LINEARS:
            blocks[name] = {"kernel": np.stack([_to_numpy(lyr[name]["weight"]).T for lyr in layers])}
            if "bias" in layers[0][name]:
                blocks[name]["bias"] = np.stack([_to_numpy(lyr[name]["bias"]) for lyr in layers])
        else:
            blocks[name] = _stack([lyr[name] for lyr in layers])
    tree = {
        "embedding": {"weight": _to_numpy(params["embedding"]["weight"])},
        "blocks": blocks,
        "norm": _to_numpy(params["norm"]),
        "head": {"kernel": np.ascontiguousarray(_to_numpy(params["head"]["weight"]).T)},
    }
    if "norm_bias" in params:
        tree["norm_bias"] = _to_numpy(params["norm_bias"])
    return tree


_OPT_TREES = ("master", "m", "v")


def opt_state_to_numpy(state: dict) -> dict:
    """The port's optimizer state -> the JAX ``init_optimizer_state`` layout
    as numpy arrays (master/m/v in the param-tree layout)."""
    return {k: params_to_numpy(v) if k in _OPT_TREES else _to_numpy(v) for k, v in state.items()}


def opt_state_from_jax(state: dict, device="cuda") -> dict:
    """A JAX optimizer state (numpy or jax arrays) -> the port's, on ``device``."""
    device = get_device(device)
    return {k: params_from_jax(v, device) if k in _OPT_TREES else _to_torch(v, device)
            for k, v in state.items()}
