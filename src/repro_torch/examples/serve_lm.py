"""Serve a small LM with batched requests through the slot scheduler
(continuous batching over a shared KV cache), as ``examples/serve_lm.py``.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm --requests 8 [--device cpu]

No hand-written kernel is on this path: the decode step is plain torch
ops, as the reference leaves it to XLA.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..launch.serve import Request, Server
from ..models.transformer import LMConfig

CFG = LMConfig(name="serve-demo", n_layers=4, d_model=128, n_heads=8, n_kv_heads=4,
               d_ff=256, vocab_size=512, dtype="float32")
MAX_BATCH, MAX_SEQ = 4, 128


def requests(n: int, max_new: int):
    """The JAX script's ``n`` seeded requests (prompts of 3-8 tokens)."""
    rng = np.random.default_rng(0)
    return [Request(rid=i, prompt=list(rng.integers(1, 512, int(rng.integers(3, 9)))),
                    max_new=max_new)
            for i in range(n)]


def main(argv=None, params=None) -> dict:
    """Serves the requests; ``params``: carried weights (a tree like
    ``transformer.init``'s, on the device) in place of the server's seeded
    init.  Returns ``{"server": Server, "done": served requests}``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs on the CPU)")
    args = ap.parse_args(argv)

    server = Server(CFG, params=params, max_batch=MAX_BATCH, max_seq=MAX_SEQ,
                    device=args.device)
    done = server.serve(requests(args.requests, args.max_new))
    for r in done:
        print(f"req {r.rid}: {len(r.prompt)} prompt toks -> {r.out}", flush=True)
    if not all(r.done for r in done):
        raise RuntimeError("serve_lm: a request was left unfinished")
    print("SERVE_LM_OK", flush=True)
    return {"server": server, "done": done}


if __name__ == "__main__":
    main()
