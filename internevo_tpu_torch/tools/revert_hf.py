"""Import a HuggingFace llama, internlm or internlm2 model folder into a
checkpoint of the port, the counterpart of the root ``tools/revert_hf.py``
(reference ``transformers/revert_internlm*.py``):

    python -m internevo_tpu_torch.tools.revert_hf --config configs/7B_llama2.py \\
        --hf_path <hf folder> --out llm_ckpts/imported [--format llama|internlm|internlm2]

The folder's weights are read without ``transformers``
(``checkpoint/convert.py::read_hf_state_dict``: ``pytorch_model.bin``,
``model.safetensors`` or indexed shards), cast to the dtypes of the model
the config builds (initialized on the host from seed 1024, as JAX's
importer does), and written as ``<out>/arrays_model/params.pt`` with a
``0.step`` stamp; load it with
``ckpt.load_ckpt_info=dict(path=<out>, content=("model",), ckpt_type="internevo")``.
"""

from __future__ import annotations

import argparse
import os

import torch

from ..checkpoint import convert
from ..checkpoint.checkpoint_manager import MODEL_FOLDER, PARAMS_FILE, assign_tree
from ..core.config import Config
from ..initialize.launch import args_sanity_check
from ..train.pipeline import initialize_model

IMPORTERS = {"llama": convert.from_hf_llama, "internlm": convert.from_hf_internlm,
             "internlm2": convert.from_hf_internlm2}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config", required=True)
    parser.add_argument("--hf_path", required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--format", default="llama", choices=sorted(IMPORTERS))
    args = parser.parse_args(argv)

    config = args_sanity_check(Config.from_file(args.config))
    model, params = initialize_model(config, "cpu", torch.Generator().manual_seed(1024))
    assign_tree(params, IMPORTERS[args.format](convert.read_hf_state_dict(args.hf_path), model.config),
                "hf", cast=True)
    os.makedirs(os.path.join(args.out, MODEL_FOLDER), exist_ok=True)
    torch.save(params, os.path.join(args.out, MODEL_FOLDER, PARAMS_FILE))
    with open(os.path.join(args.out, "0.step"), "w") as f:
        f.write("0")
    print(f"imported {args.hf_path} -> {args.out} ({args.format})")


if __name__ == "__main__":
    main()
