"""Train a ~100M-parameter MoE LM for a few hundred steps with the full
production path, as ``examples/train_lm.py``: the train step, asynchronous
checkpoints, auto-resume, deterministic data, optional gradient
compression.

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 200        # full run
    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 20 --tiny  # CI-sized

``--device cpu`` runs on the CPU.  The checkpoints go to ``--ckpt``
(default: ``repro_torch_lm_ckpt`` in the temporary directory); a snapshot
already there is resumed.  No hand-written kernel is on this path.
"""

from __future__ import annotations

import argparse
import os
import tempfile

from ..launch.train import Trainer, TrainerConfig, tiny_model
from ..models.layers import MoEConfig
from ..models.transformer import LMConfig


def model_100m(vocab: int = 32_000) -> LMConfig:
    # ~104M params: 8L × d512 × ff2048(moe 8e top2) + 32k vocab
    return LMConfig(
        name="moe-100m", n_layers=8, d_model=512, n_heads=8, n_kv_heads=4,
        d_ff=2048, vocab_size=vocab, dtype="float32", remat=False,
        moe=MoEConfig(n_experts=8, top_k=2, d_expert=1024),
    )


def main(argv=None, params=None) -> dict:
    """Trains; ``params``: starting weights (a tree like
    ``transformer.init``'s, on the device; trained in place) in place of
    the seeded init.  Returns ``{"trainer": Trainer, "metrics": the last
    step's, "losses": every step's loss run here, as floats}``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_lm_ckpt"))
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs on the CPU)")
    args = ap.parse_args(argv)

    model = tiny_model() if args.tiny else model_100m()
    n_params = model.param_count
    print(f"model {model.name}: {n_params/1e6:.1f}M params "
          f"({model.active_param_count/1e6:.1f}M active)", flush=True)
    cfg = TrainerConfig(
        model=model,
        global_batch=8 if args.tiny else 16,
        seq_len=128 if args.tiny else 256,
        steps=args.steps,
        ckpt_dir=args.ckpt,
        ckpt_every=max(args.steps // 5, 1),
        compress_grads=args.compress_grads,
    )
    tr = Trainer(cfg, device=args.device, params=params)
    losses = []
    step = tr._step

    def logged(*state):
        out = step(*state)
        losses.append(out[2]["loss"])       # the trainer reads it right after
        return out

    tr._step = logged
    metrics = tr.run()
    print(f"TRAIN_LM_OK loss={float(metrics['loss']):.4f}", flush=True)
    return {"trainer": tr, "metrics": metrics, "losses": [float(x) for x in losses]}


if __name__ == "__main__":
    main()
