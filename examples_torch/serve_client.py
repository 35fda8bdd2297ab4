"""Minimal client of the port's HTTP server (standard library only; the JAX
package's examples/serve_client.py, ported, with ``--adapter``).

    # terminal 1: serve (a random tiny model without --ckpt; see
    #             python -m torch_bnb_fp4_tpu_torch.serve --help)
    python -m torch_bnb_fp4_tpu_torch.serve --port 8000 [--lora a=ADAPTER_DIR]

    # terminal 2:
    python examples_torch/serve_client.py --prompt 1,2,3 --max-tokens 16
    python examples_torch/serve_client.py --prompt 1,2,3 --stream
    python examples_torch/serve_client.py --prompt 1,2,3 --adapter a
    python examples_torch/serve_client.py --stats

With a server started with --tokenizer, pass --text instead of --prompt.
``--adapter NAME`` picks one of the adapters the server was started with
(``--lora NAME=DIR``); an unknown name is answered with 400.
"""

from __future__ import annotations

import argparse
import json
import sys
import urllib.error
import urllib.request


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--prompt", help="comma-separated token ids")
    ap.add_argument("--text", help="text prompt (server must run with --tokenizer)")
    ap.add_argument("--max-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=None)
    ap.add_argument("--top-p", type=float, default=None)
    ap.add_argument("--adapter", default=None, help="LoRA adapter name (server started with --lora NAME=DIR)")
    ap.add_argument("--stream", action="store_true")
    ap.add_argument("--stats", action="store_true")
    args = ap.parse_args()
    base = f"http://{args.host}:{args.port}"

    if args.stats:
        with urllib.request.urlopen(f"{base}/v1/stats", timeout=60) as r:
            print(json.dumps(json.loads(r.read()), indent=2))
        return 0

    body: dict = {"max_tokens": args.max_tokens, "stream": args.stream}
    if args.text is not None:
        body["text"] = args.text
    elif args.prompt is not None:
        body["prompt"] = [int(t) for t in args.prompt.split(",")]
    else:
        ap.error("need --prompt, --text, or --stats")
    for key in ("temperature", "top_p", "adapter"):
        if getattr(args, key) is not None:
            body[key] = getattr(args, key)

    req = urllib.request.Request(f"{base}/v1/completions", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            if not args.stream:
                print(json.dumps(json.loads(r.read()), indent=2))
                return 0
            for line in r:  # server-sent events: first {"uid"}, then {"token"} each, then {"done"}
                line = line.strip()
                if not line.startswith(b"data: "):
                    continue
                obj = json.loads(line[6:])
                if "token" in obj:
                    print(obj["token"], end=" ", flush=True)
                elif "done" in obj:
                    print("\n" + json.dumps(obj["done"], indent=2))
                elif "error" in obj:
                    print(f"error: {obj['error']}", file=sys.stderr)
                    return 1
    except urllib.error.HTTPError as e:
        print(f"error {e.code}: {json.loads(e.read()).get('error')}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
