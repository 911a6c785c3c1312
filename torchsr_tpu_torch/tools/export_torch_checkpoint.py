"""Write a generator checkpoint under the reference's or a public naming.

The port's counterpart of ``tools/export_torch_checkpoint.py``: it reads
the port's ``.pth`` (a training checkpoint, or any scheme the loader
takes) or a JAX ``.ckpt``, and writes the generator alone:

- ``--scheme reference``: ``{"epoch", "phase", "state"}`` with the
  reference TorchSR's module names;
- ``--scheme rrdbnet`` (ESRGAN only): xinntao's new-arch names, a bare
  state_dict;
- ``--scheme basicsr`` (ESRGAN only): BasicSR / Real-ESRGAN names,
  wrapped as ``{"params": state_dict}``.

Each loads back through ``load_checkpoint`` (``test``, ``serve``,
``eval``, ``export``, ``train --psnr-checkpoint``) to the same weights.

Usage: python -m torchsr_tpu_torch.tools.export_torch_checkpoint
       esrgan-gan-best.pth [--model esrgan|srgan]
       [--scheme reference|rrdbnet|basicsr] [--out PATH]
(default out: ``{input stem}-{scheme}.pth`` beside the input).
"""

from __future__ import annotations

import argparse
import os


def export(checkpoint: str, scheme: str = "reference",
           model: str | None = None, out: str | None = None) -> str:
    """Write ``checkpoint``'s generator under ``scheme``; returns the
    output path."""
    import torch

    from torchsr_tpu_torch.models.torch_compat import (
        externalize_esrgan_sd,
        is_esrgan_sd,
    )
    from torchsr_tpu_torch.utils.checkpoint import load_checkpoint

    ckpt = load_checkpoint(checkpoint)
    if ckpt is None:
        raise FileNotFoundError(f"checkpoint not found: {checkpoint}")
    sd = {k: v.detach().cpu().contiguous() for k, v in ckpt["state"].items()}
    model = model or ("esrgan" if is_esrgan_sd(sd) else "srgan")
    if model != "esrgan" and scheme != "reference":
        raise ValueError("--scheme applies to ESRGAN only (SRGAN has no "
                         "public RRDBNet counterpart)")
    if scheme == "reference":
        payload = {"epoch": ckpt["epoch"], "phase": ckpt["phase"],
                   "state": sd}
    elif scheme == "rrdbnet":  # xinntao's loaders take a bare state_dict
        payload = externalize_esrgan_sd(sd, "rrdbnet")
    else:  # BasicSR's take {"params": state_dict}
        payload = {"params": externalize_esrgan_sd(sd, scheme)}
    out = out or f"{os.path.splitext(checkpoint)[0]}-{scheme}.pth"
    torch.save(payload, out)
    return out


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("checkpoint", help="the port's .pth or a JAX .ckpt")
    parser.add_argument("--model", choices=["srgan", "esrgan"],
                        help="default: told by the checkpoint's keys")
    parser.add_argument("--scheme", default="reference",
                        choices=["reference", "rrdbnet", "basicsr"])
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    out = export(args.checkpoint, args.scheme, args.model, args.out)
    print(f"Wrote {out} (scheme={args.scheme})")
    return out


if __name__ == "__main__":
    main()
