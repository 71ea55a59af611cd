#!/usr/bin/env python3
"""Host time per ``dot_moa`` call of one checkout of the PyTorch port, on a GPU.

    python3 scripts/torch_host_path.py [--src DIR] [--iters N]

``--src`` is the ``src`` directory whose ``repro_torch`` is measured (default:
this repository's), so an older checkout, unpacked beside this one, is timed
by the same code: ``chip_smoke.host_path`` (the host clock over ``N``
enqueued decode-shape calls, 4 x 4096 @ 4096 x 1024 bf16, then one
synchronise). Prints one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--iters", type=int, default=1000)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_host_path: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(1, ROOT)
    import chip_smoke
    from repro_torch.kernels import _build
    _build.build(["dot_moa"])
    out = chip_smoke.host_path(torch, iters=args.iters)
    print(json.dumps({"src": args.src, "iters": args.iters,
                      "nvidia_smi": chip_smoke.nvidia_smi(), **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
