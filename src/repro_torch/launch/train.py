"""LM training loop, as ``repro.launch.train``: the train step, checkpoints
with auto-resume, the straggler monitor and deterministic data.

Integrates:
  * ``transformer.make_train_step`` (autograd, then AdamW in place on the
    cosine schedule), or with ``compress_grads`` the same step with each
    gradient int8-quantised under error feedback before the update;
  * ``CheckpointManager``: asynchronous atomic saves every ``ckpt_every``
    steps and at the end, rotation, and auto-resume from the latest
    snapshot in ``ckpt_dir`` (a snapshot the JAX trainer wrote resumes
    here, and the other way round);
  * ``StragglerMonitor``: per-step watermarks (flagged steps are printed;
    ``ElasticPolicy`` is kept for the re-mesh a fleet would make);
  * ``TokenPipeline``: batches as a function of (seed, step), so a resumed
    run sees the batches the uninterrupted run saw.

The trainer runs on one device (the card unless ``device="cpu"``).  Its
``mesh`` (the reference's default: 1 × 1 over ("data", "model")) names
the axes that ``_shardings`` filters the reference's parameter, moment
and batch specs to; on one device they place nothing.  An elastic
restore over several cards waits for a mesh of distinct devices (ROADMAP
queue 1, item 23).

CLI:
    PYTHONPATH=src python -m repro_torch.launch.train --steps 20 --ckpt DIR
``--compress-grads`` turns on the compressed step; ``--device cpu`` runs
on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

import torch

from ..checkpoint import CheckpointManager
from ..core.graph import _device
from ..data import TokenPipeline
from ..core.mesh import Mesh
from ..distributed.fault import ElasticPolicy, StragglerMonitor
from ..distributed.mesh_utils import P, filter_pspec
from ..models import transformer as T
from ..models.layers import MoEConfig
from ..optim import AdamWState, adamw_init, adamw_update, cosine_schedule
from ..optim.compression import compressed_gradient, compression_init


@dataclasses.dataclass
class TrainerConfig:
    model: T.LMConfig
    global_batch: int = 8
    seq_len: int = 128
    steps: int = 50
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 10
    seed: int = 0
    compress_grads: bool = False
    lr_peak: float = 3e-4


class Trainer:
    """``params``: starting parameters (a tree like ``transformer.init``'s,
    on ``device``; trained in place) in place of the seeded init; a
    snapshot in ``ckpt_dir`` still takes precedence.  ``mesh``: the axes
    the specs are filtered to (1 × 1 over ("data", "model") by default)."""

    def __init__(self, cfg: TrainerConfig, device=None, params=None, mesh: Mesh = None):
        self.cfg = cfg
        self.device = _device(device)
        self.mesh = mesh if mesh is not None else Mesh({"data": 1, "model": 1},
                                                       device=self.device)
        self.monitor = StragglerMonitor()
        self.elastic = ElasticPolicy()
        self.pipeline = TokenPipeline(
            vocab_size=cfg.model.vocab_size, seq_len=cfg.seq_len,
            global_batch=cfg.global_batch, seed=cfg.seed,
        )
        self.ckpt = CheckpointManager(cfg.ckpt_dir) if cfg.ckpt_dir else None
        self._build(params)

    # -- sharding helpers ---------------------------------------------------
    def _shardings(self):
        """(param specs, AdamW state specs, batch specs) filtered to the
        mesh's axes: the reference's ``NamedSharding`` trees' specs."""
        param_sh = T.tree_map(self._filter, T.param_specs(self.cfg.model, fsdp=True))
        opt_sh = AdamWState(step=P(), mu=param_sh, nu=param_sh)
        batch_sh = {k: self._filter(P(("pod", "data"), None)) for k in ("tokens", "labels")}
        return param_sh, opt_sh, batch_sh

    def _filter(self, spec: P) -> P:
        return filter_pspec(spec, self.mesh)

    # -- build / restore ----------------------------------------------------
    def _build(self, params):
        cfg = self.cfg
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
            params = T.init(gen, cfg.model, device=self.device)
        self.params = params
        self.opt = adamw_init(self.params)
        self.step_num = 0

        if cfg.compress_grads:
            self.comp_state = compression_init(self.params)

            def step_with_compression(params, opt, batch, comp):
                (loss, metrics), grads = T.value_and_grad(params, cfg.model, batch)
                grads, err = _split(T.tree_map(compressed_gradient, grads, comp.error))
                comp = dataclasses.replace(comp, error=err)
                lr = cosine_schedule(opt.step, 100, cfg.steps, cfg.lr_peak)
                params, opt = adamw_update(grads, opt, params, lr)
                return params, opt, dict(metrics, loss=loss), comp

            self._step = step_with_compression
        else:
            self.comp_state = None
            self._step = T.make_train_step(cfg.model, lr_peak=cfg.lr_peak,
                                           total_steps=cfg.steps)

        # auto-resume
        if self.ckpt and self.ckpt.latest_step() is not None:
            state = {"params": self.params, "opt": self.opt}
            restored, step = self.ckpt.restore_resharded(state, self.device)
            self.params, self.opt = restored["params"], restored["opt"]
            self.step_num = step
            print(f"[train] resumed from step {step}")

    # -- main loop ------------------------------------------------------------
    def run(self):
        cfg = self.cfg
        metrics = {}
        while self.step_num < cfg.steps:
            batch = {k: v.to(self.device) for k, v in
                     self.pipeline.batch(self.step_num).items()}
            self.monitor.step_start()
            if self.comp_state is not None:
                self.params, self.opt, metrics, self.comp_state = self._step(
                    self.params, self.opt, batch, self.comp_state)
            else:
                self.params, self.opt, metrics = self._step(
                    self.params, self.opt, batch)
            loss = float(metrics["loss"])       # waits for the step
            straggling = self.monitor.step_end()
            self.step_num += 1
            if self.ckpt and (self.step_num % cfg.ckpt_every == 0
                              or self.step_num == cfg.steps):
                self.ckpt.save({"params": self.params, "opt": self.opt},
                               self.step_num, blocking=False,
                               metadata={"loss": loss})
            if straggling:
                print(f"[train] straggler flagged at step {self.step_num}")
            if self.step_num % 10 == 0 or self.step_num == cfg.steps:
                print(f"[train] step {self.step_num} loss {loss:.4f}")
        if self.ckpt:
            self.ckpt.wait()
        return metrics


def _split(pairs):
    """A tree of (a, b) pairs as two trees."""
    if isinstance(pairs, dict):
        a, b = {}, {}
        for k, v in pairs.items():
            a[k], b[k] = _split(v)
        return a, b
    return pairs


def tiny_model(vocab: int = 512) -> T.LMConfig:
    return T.LMConfig(
        name="tiny-moe-100m", n_layers=4, d_model=256, n_heads=8,
        n_kv_heads=4, d_ff=1024, vocab_size=vocab, dtype="float32",
        moe=MoEConfig(n_experts=4, top_k=2, d_expert=512), remat=False,
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' for the plain CPU run)")
    args = ap.parse_args()
    cfg = TrainerConfig(
        model=tiny_model(), global_batch=args.batch, seq_len=args.seq,
        steps=args.steps, ckpt_dir=args.ckpt,
        compress_grads=args.compress_grads,
    )
    tr = Trainer(cfg, device=args.device)
    metrics = tr.run()
    print(f"FINAL loss={float(metrics['loss']):.4f}")


if __name__ == "__main__":
    main()
