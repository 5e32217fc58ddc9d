"""Batched LM serving loop: continuous batching over a shared KV cache, as
``repro.launch.serve``.

Slot-based scheduler: a fixed pool of ``max_batch`` sequence slots;
requests are admitted into free slots, every decode tick advances ALL
active slots with one batched step (parked slots are masked), finished
sequences free their slot.  Prefill is per request (one ``_prefill`` call
that feeds the prompt through the masked decode step a position at a
time); decode is the shared batched step.

On the card (a small random model):
    PYTHONPATH=src python -m repro_torch.launch.serve --requests 6
``--device cpu`` runs it on the CPU (for the tests).
"""

from __future__ import annotations

import argparse
import dataclasses
import warnings
from typing import List, Optional

import numpy as np
import torch

from ..core.graph import _device
from ..models import transformer as T


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list
    max_new: int
    out: list = dataclasses.field(default_factory=list)
    slot: int = -1
    pos: int = 0
    done: bool = False
    reject_reason: Optional[str] = None


class Server:
    def __init__(self, cfg: T.LMConfig, params=None, max_batch: int = 4,
                 max_seq: int = 256, seed: int = 0, device=None):
        self.cfg = cfg
        self.device = _device(device)
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.params = params if params is not None else T.init(
            torch.Generator(device=self.device).manual_seed(seed), cfg, device=self.device)
        self.cache = T.init_cache(cfg, max_batch, max_seq, device=self.device)
        # slot occupancy lives in free_slots/slots; tick() rebuilds the
        # live mask from them every step
        self.free_slots = list(range(max_batch))
        self.slots: List[Optional[Request]] = [None] * max_batch
        self._decode = T.make_decode(cfg)
        self._prefill = self._make_prefill()

    def _make_prefill(self):
        """One call per admitted prompt: the prompt's tokens go through the
        masked decode step one position at a time (the reference's
        ``lax.scan``), with the tokens and positions of every step copied
        to the device at once.  The steps skip the unembedding, whose
        logits prefill drops."""
        cfg, nb = self.cfg, self.max_batch

        def prefill(params, cache, toks, slot, mask):
            n = toks.shape[0]
            bt = torch.zeros((n, nb, 1), dtype=torch.int32, device=toks.device)
            bt[:, slot, 0] = toks
            pos = torch.zeros((n, nb), dtype=torch.int32, device=toks.device)
            pos[:, slot] = torch.arange(n, dtype=torch.int32, device=toks.device)
            for i in range(n):
                T.decode_layers(params, cfg, cache, bt[i], pos[i], mask)
            return cache

        return prefill

    # -- admission -----------------------------------------------------------
    def admit(self, req: Request) -> bool:
        """Admit ``req`` into a free slot.  Returns False when no slot is
        free (the caller retries later) OR when the request can never fit:
        then it is marked done with ``reject_reason``."""
        n_prompt = len(req.prompt)
        if n_prompt >= self.max_seq:
            req.done = True
            req.reject_reason = (
                f"prompt length {n_prompt} cannot fit: max_seq={self.max_seq} "
                f"leaves no room to generate")
            return False
        room = self.max_seq - n_prompt
        if req.max_new > room:
            warnings.warn(
                f"request {req.rid}: max_new={req.max_new} overflows "
                f"max_seq={self.max_seq} with prompt length {n_prompt}; "
                f"clamped to {room}")
            req.max_new = room
        if not self.free_slots:
            return False
        slot = self.free_slots.pop()
        req.slot = slot
        self.slots[slot] = req
        # prefill all but the LAST prompt token into this slot's cache
        # (write-masked for the other slots); the first tick feeds the last
        # prompt token and yields the first generated token
        if n_prompt > 1:
            mask = torch.zeros((self.max_batch,), dtype=torch.bool, device=self.device)
            mask[slot] = True
            self.cache = self._prefill(
                self.params, self.cache,
                torch.tensor(np.asarray(req.prompt[:-1], np.int32), device=self.device),
                slot, mask)
        req.pos = n_prompt - 1
        return True

    # -- one decode tick for every active slot -------------------------------
    def tick(self):
        batch_tokens = np.zeros((self.max_batch, 1), np.int32)
        pos = np.zeros((self.max_batch,), np.int32)
        mask = np.zeros((self.max_batch,), bool)
        live = [r for r in self.slots if r is not None and not r.done]
        if not live:
            return
        for r in live:
            last = (r.out[-1] if r.out else r.prompt[-1])
            batch_tokens[r.slot, 0] = last
            pos[r.slot] = r.pos        # each slot decodes at its own offset
            mask[r.slot] = True
        dev = self.device
        logits, self.cache = self._decode(
            self.params, self.cache, torch.from_numpy(batch_tokens).to(dev),
            torch.from_numpy(pos).to(dev), torch.from_numpy(mask).to(dev))
        # greedy; torch.argmax returns the first index of a tie, as jnp's
        nxt = logits[:, 0].argmax(dim=-1).cpu().numpy()
        for r in live:
            r.out.append(int(nxt[r.slot]))
            r.pos += 1
            if len(r.out) >= r.max_new or r.pos >= self.max_seq - 1:
                r.done = True
                self.free_slots.append(r.slot)
                self.slots[r.slot] = None

    def serve(self, requests: List[Request]):
        pending = list(requests)
        while pending or any(s is not None for s in self.slots):
            while pending:
                req = pending.pop(0)
                if not self.admit(req) and not req.done:
                    # no free slot yet: keep FIFO order and retry next tick
                    # (a rejected request is done and simply dropped here)
                    pending.insert(0, req)
                    break
            self.tick()
        return [r for r in requests if r.done]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs on the CPU)")
    args = ap.parse_args(argv)
    cfg = T.LMConfig(name="serve-demo", n_layers=2, d_model=64, n_heads=4,
                     n_kv_heads=2, d_ff=128, vocab_size=256, dtype="float32")
    server = Server(cfg, max_batch=4, max_seq=64, device=args.device)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=list(rng.integers(1, 256, 5)),
                    max_new=args.max_new) for i in range(args.requests)]
    out = server.serve(reqs)
    for r in out:
        tail = f"REJECTED ({r.reject_reason})" if r.reject_reason else r.out
        print(f"req {r.rid}: prompt {r.prompt} -> {tail}")
    # max_new may have been clamped at admission; rejected requests carry
    # a reason and no output
    assert all(len(r.out) == r.max_new
               for r in out if r.reject_reason is None)
    print("SERVE_OK")


if __name__ == "__main__":
    main()
