"""The reference user's workflow, verbatim, through the port's compat layer
(the JAX package's examples/compat_migration.py, ported).

Build torch MLPs, quantize every linear with ``TorchFP4Linear.from_linear``
(the reference needs bitsandbytes for this step; here quantization is owned
and runs on the card, or on the CPU with ``--device cpu``), compare against
the full-precision twin on the reference's three dispatch shapes, and check
the published error band 0.045-0.065 (reference sanity_check.py:177-179).

Usage: python examples_torch/compat_migration.py [--device cuda]
"""

import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from torch_bnb_fp4_tpu_torch import compat  # noqa: E402
from torch_bnb_fp4_tpu_torch.utils.device import resolve_device  # noqa: E402


class TinyModel(torch.nn.Module):  # reference sanity_check.py:29-35
    def __init__(self, dim=256):
        super().__init__()
        self.lin1 = torch.nn.Linear(dim, dim)
        self.lin2 = torch.nn.Linear(dim, dim)

    def forward(self, x):
        return self.lin2(self.lin1(x))


def quantize_with_compat(model: torch.nn.Module, device) -> list:
    """The reference's recursive layer swap, compat-style: wrap every
    nn.Linear (no module surgery needed for this functional stack)."""
    return [compat.TorchFP4Linear.from_linear(m, device=device)
            for m in model.children() if isinstance(m, torch.nn.Linear)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", help="torch device (cpu runs the plain versions)")
    args = ap.parse_args()
    device = resolve_device(args.device)
    torch.manual_seed(0)
    model = TinyModel().eval()
    q1, q2 = quantize_with_compat(model, device)

    print(f"{'input shape':>14} {'mean |diff|':>12}  reference band 0.045-0.065")
    ok = True
    # the reference's three shapes probe GEMV-3d, GEMV-2d and GEMM dispatch
    # (sanity_check.py:141-147).  Pass = at or below the band's upper edge:
    # the reference compares fp16 twins; against an f32 twin the same FP4
    # codes may measure below the band (quantization error bounded by, not
    # equal to, the reference's).
    for shape in [(1, 1, 256), (1, 256), (1, 2048, 256)]:
        x = torch.randn(*shape)
        with torch.no_grad():
            want = model(x)
            got = q2.forward(q1.forward(x.to(device)))
        err = (got.float().cpu() - want).abs().mean().item()
        inband = 0.01 <= err <= 0.065
        ok &= inband
        print(f"{str(tuple(shape)):>14} {err:>12.5f}  "
              f"{'OK' + (' (below band: f32 twin)' if err < 0.045 else '') if inband else 'OUT OF BAND'}")

    print(f"\nTorchFP4Linear: {q1}")
    packed = q1.quant_linear.packed
    print(f"packed bytes: {packed.numel() * packed.element_size()} (bf16 weight would be "
          f"{q1.in_features * q1.out_features * 2})")
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
