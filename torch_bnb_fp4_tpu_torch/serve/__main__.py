"""Serve a packed-FP4 checkpoint over HTTP.

    python -m torch_bnb_fp4_tpu_torch.serve --ckpt <packed_dir> [--port 8000]
        [--max-batch 8] [--max-len 2048] [--inner-steps 8] [--temperature 0]
        [--top-p 1.0] [--top-k 0] [--prefill-chunk 0] [--spec-tokens 0]
        [--prefix-cache] [--prefix-store 0] [--no-sliding-kv] [--logprobs]
        [--kv-dtype bfloat16] [--warmup-prompt-len N] [--prefill-shadow]
        [--lora DIR | --lora NAME=DIR ...] [--lora-merge]
        [--tokenizer DIR] [--device cuda] [--multihost [--coordinator HOST:PORT]
        [--tp N]]

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
the CPU.  --warmup-prompt-len runs every serving program (the decode CUDA
graphs included; with --prefill-chunk the chunk graph of every width and row
count) before the server accepts requests.  ``--lora DIR`` serves
one HF PEFT adapter on every request (its exact low-rank delta beside the
untouched FP4 bases), ``--lora-merge`` folds it into the weights instead
(requantized: no cost per token); ``--lora NAME=DIR``, repeatable, stacks
several adapters on the one base and each request picks one with
``{"adapter": NAME}`` (omitted: the base model; an unknown name is a 400).
Adapters attach before ``--prefill-shadow``, which then shadows their bases.
Ctrl-C (SIGINT) stops the server and exits 0.

``--multihost`` serves one model over several processes, one rank each
(``parallel/tp.py``, ``serve/multihost.py``): every rank runs this command;
the job's address, size and this rank come from ``--coordinator HOST:PORT``
and the ``RANK`` / ``WORLD_SIZE`` environment, or from torchrun's
environment alone (``torchrun --nproc-per-node N -m
torch_bnb_fp4_tpu_torch.serve --multihost ...``).  ``--tp N`` is the
model-axis width (default: the world size); the data axis takes the rest
(world / N replicas, ``--max-batch`` a multiple of it).  This differs from
the JAX CLI by design: there a process drives several devices, so data =
process count and model = devices per process; here one process drives one
device.  Each rank loads the checkpoint onto the CPU, repacked and fused for
the model axis, attaches the adapters there, keeps its shard on its device
(``--device``: ``cuda`` is ``cuda:{local rank % cards}``, ``cpu`` for the
plain versions), then attaches the prefill shadows to its shard.  Rank 0
serves HTTP; the others follow its ticks and exit 0 when it stops.
"""

from __future__ import annotations

import argparse
import logging
import os
import time


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
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--spec-tokens", type=int, default=0)
    ap.add_argument("--prefix-cache", action="store_true")
    ap.add_argument("--prefix-store", type=int, default=0,
                    help="keep up to N retired requests' KV on the card so a shared system prompt hits the prefix "
                         "cache after its donor finishes (N decode slots' worth of KV; LRU; requires "
                         "--prefix-cache)")
    ap.add_argument("--logprobs", action="store_true", help="emit per-token logprobs on every completion")
    ap.add_argument("--kv-dtype", default="bfloat16", choices=["bfloat16", "float8_e4m3fn"])
    ap.add_argument("--warmup-prompt-len", type=int, default=0,
                    help="run every serving program (decode CUDA graphs, prefill buckets or, with --prefill-chunk, "
                         "every chunk graph) for prompts up to this length before accepting traffic")
    ap.add_argument("--lora", action="append", default=None, metavar="DIR|NAME=DIR",
                    help="HF PEFT LoRA adapter dir to serve over the base (exact low-rank delta; base bytes "
                         "untouched).  Repeatable as NAME=DIR for multi-adapter serving: requests then pick an "
                         "adapter with {'adapter': NAME} (omitted = base model)")
    ap.add_argument("--lora-merge", action="store_true",
                    help="fold the --lora adapter into the base weights and requantize (zero runtime overhead, FP4 "
                         "envelope on the delta)")
    ap.add_argument("--multihost", action="store_true",
                    help="multi-process serving, one rank per process: HTTP on rank 0, the engine loop in lockstep "
                         "on every rank (torchrun's environment, or --coordinator with RANK/WORLD_SIZE)")
    ap.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                    help="the job's rendezvous address for --multihost (this rank and the world size from the "
                         "RANK and WORLD_SIZE environment variables)")
    ap.add_argument("--tp", type=int, default=0,
                    help="model-axis width under --multihost (0 = the world size; the data axis takes the rest)")
    return ap


def multihost_rules(args: argparse.Namespace) -> None:
    """The --multihost, --coordinator and --tp rules: a ``ValueError`` with
    the reason where they are broken (a rank's own count of processes is
    only known after the rendezvous, :func:`build_engine`)."""
    if args.tp < 0:
        raise ValueError(f"--tp must be >= 0, got {args.tp}")
    if not args.multihost:
        if args.coordinator is not None:
            raise ValueError("--coordinator applies to --multihost only")
        if args.tp > 1:
            raise ValueError(f"--tp {args.tp} needs --multihost: one process serves one rank of the model axis")
        return
    if args.coordinator is None:
        missing = [v for v in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK") if v not in os.environ]
    else:
        missing = [v for v in ("WORLD_SIZE", "RANK") if v not in os.environ]
    if missing:
        raise ValueError(f"--multihost needs {', '.join(missing)} in the environment (torchrun sets them; with "
                         "--coordinator set RANK and WORLD_SIZE)")


def lora_specs(args: argparse.Namespace) -> tuple[dict[str, str] | None, str | None]:
    """The --lora flags under the JAX CLI's rules: (name -> dir, None) for
    per-request serving when there are several or one is NAME=DIR, else
    (None, the one dir or None).  Breaking a rule raises ``ValueError`` with
    the JAX CLI's message."""
    if not args.lora:
        return None, None
    if len(args.lora) > 1 or "=" in args.lora[0]:
        named = {}
        for spec in args.lora:
            if "=" not in spec:
                raise ValueError(f"multi-adapter --lora needs NAME=DIR, got {spec!r}")
            name, path = spec.split("=", 1)
            named[name] = path
        if args.lora_merge:
            raise ValueError("--lora-merge only applies to a single unnamed --lora")
        return named, None
    return None, args.lora[0]


def build_engine(args: argparse.Namespace):
    """The engine the parsed flags ask for: the model (the checkpoint, or a
    tiny random one), the adapters (:func:`lora_specs`: stacked for
    per-request serving, or one attached, or merged with --lora-merge), the
    shadows, the engine settings, and the warmup when --warmup-prompt-len is
    set.  With --multihost it first joins the job (``init_multihost``),
    builds the mesh and keeps this rank's shard.  Invalid settings raise
    ``ValueError`` as the JAX engine does."""
    from ..models import transformer as T
    from ..models.linear import attach_prefill_shadow
    from ..utils.device import resolve_device
    from . import Engine, EngineConfig

    named_loras, lora_dir = lora_specs(args)
    mesh, tp = None, 1
    if args.multihost:
        import torch.distributed as dist

        from ..parallel import init_multihost, make_mesh, validate_tp

        init_multihost(coordinator_address=args.coordinator)
        world = dist.get_world_size()
        tp = args.tp or world
        if world % tp:
            raise ValueError(f"--tp {tp} does not divide the {world} processes")
        mesh = make_mesh(n_model=tp, n_data=world // tp, device=None if args.device == "cuda" else args.device)
        logging.info("multihost: rank %d of %d, mesh data=%d x model=%d on %s (%s)", mesh.rank, world, mesh.n_data,
                     tp, mesh.device, mesh.backend)
        device = resolve_device("cpu")  # the full model lives on the CPU; each rank keeps its shard
    else:
        device = resolve_device(args.device)
    if args.ckpt:
        from ..convert import load_checkpoint

        cfg, params = load_checkpoint(args.ckpt, tp=tp, device=device)
    else:
        cfg = T.ModelConfig.tiny_test(n_layers=2)
        params = T.quantize_params(cfg, T.random_weights(cfg, seed=0), device=device)
        logging.info("no --ckpt: serving a tiny random-weight model")
    adapter_ids = None
    if named_loras:
        from ..models.lora import attach_multi_lora, load_peft_adapter

        params, adapter_ids = attach_multi_lora(params, cfg, {n: load_peft_adapter(d) for n, d in named_loras.items()})
        logging.info("attached %d LoRA adapters for per-request serving: %s", len(named_loras), sorted(adapter_ids))
    elif lora_dir:
        from ..models.lora import attach_lora, load_peft_adapter, merge_lora

        adapter = load_peft_adapter(lora_dir)
        params = (merge_lora if args.lora_merge else attach_lora)(params, cfg, adapter)
        logging.info("%s LoRA adapter %s (r=%d, alpha=%g, %d modules)", "merged" if args.lora_merge else "attached",
                     lora_dir, adapter.r, adapter.alpha, len(adapter.weights))
    if mesh is not None:
        from ..parallel import shard_params
        from ..parallel.tp import attach_local_shadow

        validate_tp(cfg, tp)
        params = shard_params(params, mesh)
        if args.prefill_shadow:
            params = attach_local_shadow(params, tp)
            logging.info("attached int8 prefill shadows to this rank's shard")
    elif args.prefill_shadow:
        params = attach_prefill_shadow(params)
        logging.info("attached int8 prefill shadows (+1 byte/weight on the device)")
    eng = Engine(params, cfg, EngineConfig(
        max_batch=args.max_batch, max_len=args.max_len, inner_steps=args.inner_steps, temperature=args.temperature,
        top_p=args.top_p, top_k=args.top_k, prefill_chunk=args.prefill_chunk, spec_tokens=args.spec_tokens,
        prefix_cache=args.prefix_cache, prefix_store=args.prefix_store, sliding_kv=not args.no_sliding_kv,
        kv_dtype=args.kv_dtype, logprobs=args.logprobs), adapter_ids=adapter_ids, mesh=mesh)
    if args.warmup_prompt_len:
        logging.info("warming up (prompts to %d)...", args.warmup_prompt_len)
        t0 = time.perf_counter()
        traces = eng.warmup(max_prompt_len=args.warmup_prompt_len)
        logging.info("warmup done in %.1f s: %s", time.perf_counter() - t0, traces)
    return eng


def main(argv: list[str] | None = None) -> None:
    ap = _parser()
    args = ap.parse_args(argv)
    try:
        lora_specs(args)
        multihost_rules(args)
    except ValueError as e:
        ap.error(str(e))
    logging.basicConfig(level=logging.DEBUG if args.verbose else logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")

    from . import EngineServer

    eng = build_engine(args)
    tok = None
    if args.tokenizer:
        from transformers import AutoTokenizer

        tok = AutoTokenizer.from_pretrained(args.tokenizer, local_files_only=True)
    if eng.mesh is not None:
        import torch.distributed as dist

        from . import MultihostEngineServer, follow

        if eng.mesh.rank != 0:
            logging.info("follower rank %d: engine loop in lockstep with rank 0", eng.mesh.rank)
            follow(eng)  # returns when rank 0's server stops
            dist.destroy_process_group()
            return
        srv = MultihostEngineServer(eng, host=args.host, port=args.port, tokenizer=tok).start()
    else:
        srv = EngineServer(eng, host=args.host, port=args.port, tokenizer=tok).start()
    # flushed: a parent reading this through a pipe waits for the line
    print(f"serving on http://{srv.host}:{srv.port}", flush=True)
    try:
        while srv._http_thread.is_alive():
            srv._http_thread.join(timeout=0.5)
    except KeyboardInterrupt:
        print("shutting down", flush=True)
        srv.stop()
    if eng.mesh is not None:
        import torch.distributed as dist

        dist.destroy_process_group()


if __name__ == "__main__":
    main()
