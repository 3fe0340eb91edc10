"""Convert a reference training bundle (``.pth``) into an HF export.

Counterpart of the JAX package's ``tools/convert_reference_bundle.py``:
reads the reference trainer's ``bundle.pth`` ({model, optimizer,
scheduler, args} pickles), maps its state dict through
``models/convert.py`` (peft LoRA keys merged), rebuilds the VoiceConfig
from the pickled args and writes the directory ``export/hf_export.py``
writes. The file holds a pickled ``argparse.Namespace``: convert only
files you trust.

Usage: python -m t5gemma_tts_tpu_torch.export.convert_reference_bundle \
           --bundle bundle.pth --out dir/ [--dtype float32]
"""

from __future__ import annotations

import argparse

import torch

from ..inference.loading import read_reference_pth
from ..models import convert
from ..models.voice import DTYPES
from .hf_export import export_hf


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m t5gemma_tts_tpu_torch.export.convert_reference_bundle")
    ap.add_argument("--bundle", required=True, help="reference bundle.pth")
    ap.add_argument("--out", required=True)
    ap.add_argument("--dtype", default="bfloat16")
    args = ap.parse_args(argv)

    sd, cfg = read_reference_pth(args.bundle)
    params = convert.torch_state_dict_to_params(
        sd, cfg, DTYPES[args.dtype], torch.device("cpu"))
    export_hf(params, cfg, args.out, dtype=args.dtype)
    print(f"converted {args.bundle} -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
