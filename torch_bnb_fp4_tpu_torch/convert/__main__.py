"""CLI: python -m torch_bnb_fp4_tpu_torch.convert <hf_model_dir> <out_dir>
         [--quant-type fp4|nf4] [--variant ramp|zramp|exact] [--quantize-lm-head]
         [--quantize-embed] [--ignore SUBSTRING ...] [--requantize]

The JAX package's converter CLI on the port: an HF safetensors checkpoint
directory to a packed FP4 checkpoint, on the host (no card, no safetensors
package needed)."""

import argparse

from .hf import convert_hf_model


def main(argv=None):
    ap = argparse.ArgumentParser(description="HF checkpoint -> packed FP4 checkpoint")
    ap.add_argument("model_dir")
    ap.add_argument("out_dir")
    ap.add_argument("--quant-type", default="fp4", choices=["fp4", "nf4"])
    ap.add_argument("--variant", default="ramp", choices=["ramp", "zramp", "exact"],
                    help="fp4 pairk codebook: ramp = fastest decode (default, slightly more accurate than exact FP4); "
                    "exact = bit-exact bnb FP4 codes")
    ap.add_argument("--quantize-lm-head", action="store_true")
    ap.add_argument("--quantize-embed", action="store_true",
                    help="quantize the token-embedding table too (FP4/NF4 codes decoded at lookup; Mistral-7B's "
                    "table goes from 262 MB to 74 MB)")
    ap.add_argument("--ignore", action="append", default=[],
                    help="substring of layer names to keep unquantized (repeatable)")
    ap.add_argument("--requantize", action="store_true",
                    help="bitsandbytes-serialized sources only: dequantize the stored codes exactly and quantize "
                    "FRESH to --quant-type/--variant instead of importing them (the ramp decode is faster than "
                    "the NF4 table lookup, at more weight error)")
    args = ap.parse_args(argv)
    if args.quant_type == "fp4" and args.variant != "exact":
        print(f"note: variant={args.variant!r} remaps the FP4 codebook at pack time (faster decode, measured "
              "slightly more accurate on Gaussian weights) -- the stored codes are NOT bit-exact bnb FP4; use "
              "--variant exact for strict bnb parity.")
    convert_hf_model(args.model_dir, args.out_dir, quant_type=args.quant_type,
                     quantize_lm_head=args.quantize_lm_head, quantize_embed=args.quantize_embed,
                     ignore=tuple(args.ignore), variant=args.variant, requantize=args.requantize)


if __name__ == "__main__":
    main()
