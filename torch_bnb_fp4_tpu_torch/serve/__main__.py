"""Serve a packed-FP4 checkpoint over HTTP.

    python -m torch_bnb_fp4_tpu_torch.serve --ckpt <packed_dir> [--port 8000]
        [--max-batch 8] [--max-len 2048] [--inner-steps 8] [--prefill-chunk 0]
        [--no-sliding-kv] [--prefill-shadow] [--tokenizer DIR] [--device cuda]

Counterpart of ``python -m torch_bnb_fp4_tpu.serve``: convert once, then
serve the packed bytes and POST token-id prompts (serve/server.py).  Without
--ckpt a 2-layer random-weight model serves (smoke testing the API).
Checkpoints load unfused, as in the JAX package; a Mixtral (mixture-of-
experts) checkpoint serves the same way, its experts through K8 (with
--prefill-shadow only the attention linears get shadows, as in the JAX
package: expert stacks have none).  A split-K checkpoint (bnb-exact FP4/NF4,
every format-1/2 checkpoint, K-sharded row-parallel entries repacked to one
shard at load) serves through K9b; --prefill-shadow then skips every split-K
linear, which keeps K9b for prefill too.  ``--device`` (default
cuda) is the port's own flag: the server runs on the card unless asked for
the CPU.  The JAX CLI's other flags are accepted and refused with "not yet
ported" when set.  Ctrl-C (SIGINT) stops the server and exits 0.
"""

from __future__ import annotations

import argparse
import logging

# JAX CLI flags the port does not serve yet (refused when not at their default)
_UNPORTED = ("--temperature", "--top-p", "--top-k", "--spec-tokens", "--prefix-cache", "--prefix-store",
             "--logprobs", "--multihost", "--coordinator", "--tp", "--kv-dtype", "--lora", "--lora-merge",
             "--warmup-prompt-len")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m torch_bnb_fp4_tpu_torch.serve", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ckpt", help="packed checkpoint dir (convert/checkpoint.py format)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=2048)
    ap.add_argument("--inner-steps", type=int, default=8)
    ap.add_argument("--prefill-chunk", type=int, default=0)
    ap.add_argument("--no-sliding-kv", action="store_true",
                    help="disable rolling sliding-window KV rings (rings need --prefill-chunk)")
    ap.add_argument("--prefill-shadow", action="store_true",
                    help="attach int8 prefill shadows (+1 byte/weight on the card): prefill GEMMs of 256 rows "
                         "or more run as pure int8 GEMMs (K5); decode is unchanged")
    ap.add_argument("--tokenizer", default=None, metavar="DIR",
                    help="local HF tokenizer dir: enables {'text': ...} prompts and decoded 'text' in completions")
    ap.add_argument("--device", default="cuda", help="torch device to serve on (cpu runs the plain versions)")
    ap.add_argument("-v", "--verbose", action="store_true")
    # accepted for the JAX CLI's command lines; refused below when set
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--spec-tokens", type=int, default=0)
    ap.add_argument("--prefix-cache", action="store_true")
    ap.add_argument("--prefix-store", type=int, default=0)
    ap.add_argument("--logprobs", action="store_true")
    ap.add_argument("--multihost", action="store_true")
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--tp", type=int, default=0)
    ap.add_argument("--kv-dtype", default="bfloat16", choices=["bfloat16", "float8_e4m3fn"])
    ap.add_argument("--lora", action="append", default=None, metavar="DIR|NAME=DIR")
    ap.add_argument("--lora-merge", action="store_true")
    ap.add_argument("--warmup-prompt-len", type=int, default=0)
    return ap


def main(argv: list[str] | None = None) -> None:
    ap = _parser()
    args = ap.parse_args(argv)
    for flag in _UNPORTED:
        dest = flag[2:].replace("-", "_")
        if getattr(args, dest) != ap.get_default(dest):
            ap.error(f"{flag} is not yet ported to torch_bnb_fp4_tpu_torch")
    logging.basicConfig(level=logging.DEBUG if args.verbose else logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")

    from ..models import transformer as T
    from ..models.linear import attach_prefill_shadow
    from ..utils.device import resolve_device
    from . import Engine, EngineConfig, EngineServer

    device = resolve_device(args.device)
    if args.ckpt:
        from ..convert import load_checkpoint

        cfg, params = load_checkpoint(args.ckpt, device=device)
    else:
        cfg = T.ModelConfig.tiny_test(n_layers=2)
        params = T.quantize_params(cfg, T.random_weights(cfg, seed=0), device=device)
        logging.info("no --ckpt: serving a tiny random-weight model")
    if args.prefill_shadow:
        params = attach_prefill_shadow(params)
        logging.info("attached int8 prefill shadows (+1 byte/weight on the device)")
    eng = Engine(params, cfg, EngineConfig(max_batch=args.max_batch, max_len=args.max_len,
                                           inner_steps=args.inner_steps, prefill_chunk=args.prefill_chunk,
                                           sliding_kv=not args.no_sliding_kv))
    tok = None
    if args.tokenizer:
        from transformers import AutoTokenizer

        tok = AutoTokenizer.from_pretrained(args.tokenizer, local_files_only=True)
    srv = EngineServer(eng, host=args.host, port=args.port, tokenizer=tok).start()
    # flushed: a parent reading this through a pipe waits for the line
    print(f"serving on http://{srv.host}:{srv.port}", flush=True)
    try:
        while srv._http_thread.is_alive():
            srv._http_thread.join(timeout=0.5)
    except KeyboardInterrupt:
        print("shutting down", flush=True)
        srv.stop()


if __name__ == "__main__":
    main()
