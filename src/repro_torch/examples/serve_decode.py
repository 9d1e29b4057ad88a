"""Serving demo: submit ragged generation requests to the
continuous-batching ``ServingEngine`` and stream tokens as they land.

    python -m repro_torch.examples.serve_decode --arch llama3.2-3b \\
        [--device cpu]

The arch's reduced config with seeded random weights, in bfloat16, as
the reference's example.  Families the engine cannot hold (a sliding
window's ring cache: starcoder2-3b, and the RG-LRU hybrid
recurrentgemma-9b) go through the blocking ``Server``, the same typed
caches underneath without continuous batching; families the port does
not run yet (enc-dec, VLM) raise, naming the slice that brings them.
"""
import argparse
import time
import warnings

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import registry as R
from repro_torch.serving import GenerationRequest, ServingEngine
from repro_torch.train.serve import Server


def serve_engine(cfg, model, args):
    rng = np.random.default_rng(0)
    max_len = args.prompt_len + args.new_tokens + 8
    eng = ServingEngine(cfg, model, decode_slots=args.batch,
                        max_len=max_len, dtype=model.dtype)
    for _ in range(args.batch):
        s = int(rng.integers(args.prompt_len // 2, args.prompt_len + 1))
        n = int(rng.integers(max(args.new_tokens // 2, 1),
                             args.new_tokens + 1))
        prompt = rng.integers(0, cfg.vocab_size, (s,)).astype(np.int32)
        rid = eng.submit(GenerationRequest(prompt=prompt,
                                           max_new_tokens=n))
        print(f"  submit rid={rid} prompt_len={s} max_new={n}")
    t0 = time.time()
    n_tok = 0
    while not eng.done:
        for rid, _tok, fin in eng.step():     # streaming events
            n_tok += 1
            if fin:
                res = eng.result(rid)
                print(f"  rid={rid} done ({res.finish_reason}): "
                      f"{res.tokens.tolist()}")
    dt = time.time() - t0
    print(f"engine: {n_tok} tokens in {dt:.2f}s ({n_tok / dt:.1f} tok/s),"
          f" {eng.executables} entries (budget {eng.executable_budget}), "
          f"{eng.captures} graphs, occupancy {eng.mean_occupancy():.2f}")
    return eng


def serve_blocking(cfg, model, args):
    rng = np.random.default_rng(0)
    srv = Server(cfg, model, dtype=model.dtype,
                 max_len=args.prompt_len + args.new_tokens + 8)
    prompts = rng.integers(0, cfg.vocab_size,
                           (args.batch, args.prompt_len))
    t0 = time.time()
    with warnings.catch_warnings():           # the known blocking path
        warnings.simplefilter("ignore", DeprecationWarning)
        out = srv.generate(prompts, args.new_tokens,
                           temperature=args.temperature)
    dt = time.time() - t0
    print(f"blocking Server: wall {dt:.2f}s "
          f"({args.batch * args.new_tokens / dt:.1f} tok/s batched)")
    for i, row in enumerate(out[:3]):
        print(f"  seq{i}: {row.tolist()}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.8,
                    help="blocking-Server fallback only; the engine "
                         "decodes greedily")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).reduced()
    model = R.init_model(cfg, seed=0, dtype=torch.bfloat16,
                         device=args.device)
    mode = R.serving_mode(cfg)
    print(f"arch={cfg.name}  serving_mode={mode}  device={args.device}")
    if mode is not None:
        return serve_engine(cfg, model, args)
    return serve_blocking(cfg, model, args)


if __name__ == "__main__":
    main()
