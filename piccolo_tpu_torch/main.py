"""CLI entry point: ``python -m piccolo_tpu_torch.main --config <ini> --log <dir>``.

The JAX package's interface (piccolo_tpu/main.py): parse the ini config,
apply ``--override k=v[,k2=v2...]``, persist the effective config to
``<log>/config.ini``, open a TensorBoard writer when one is available, and
dispatch on ``cfg.dataset`` to the harness.  ``--device`` picks the card
(``cuda``, the default) or the CPU; without a card, ``cuda`` raises.
"""

from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="piccolo_tpu_torch: omnidirectional camera localization "
                    "on an NVIDIA GPU (PyTorch/CUDA port of piccolo_tpu)"
    )
    parser.add_argument(
        "--config", type=str, default=None, required=True,
        help="Config ini file to use for running experiments",
    )
    parser.add_argument(
        "--log", type=str, default="./log",
        help="Log directory for results, artifacts, and TensorBoard",
    )
    parser.add_argument(
        "--override", type=str, default=None,
        help="Config overrides, e.g. 'num_iter=50,lr=0.2'",
    )
    parser.add_argument(
        "--no-tensorboard", action="store_true",
        help="Skip TensorBoard event writing",
    )
    parser.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="Run on the card (default) or on the CPU",
    )
    return parser


def main(argv=None) -> float:
    from .config import apply_overrides, parse_ini, save_config
    from .device import resolve_device
    from .harness.localize import localize_stanford

    args = build_parser().parse_args(argv)
    resolve_device(args.device)  # raises without a card unless --device cpu
    cfg = parse_ini(args.config)
    cfg = apply_overrides(cfg, args.override)
    if cfg.dataset == "OmniScenes":
        raise NotImplementedError(
            "the OmniScenes harness is not ported to piccolo_tpu_torch yet: "
            "its panoramas are JPEG, and the port has no JPEG decoder that "
            "runs without cv2 and PIL"
        )
    if cfg.dataset != "Stanford2D-3D-S":
        raise ValueError(f"unknown dataset: {cfg.dataset!r}")

    os.makedirs(args.log, exist_ok=True)
    save_config(cfg, args.log)

    writer = None
    if not args.no_tensorboard:
        try:
            from torch.utils.tensorboard import SummaryWriter

            writer = SummaryWriter(args.log)
        except Exception:
            writer = None

    return localize_stanford(cfg, writer, args.log, device=args.device)


if __name__ == "__main__":
    main()
