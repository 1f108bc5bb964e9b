"""DLRM convergence demo: AUC climbs on a learnable synthetic click stream.

Counterpart of ``tools/convergence_demo.py``: the same scaled-down DLRM (26
tables of 100 + 137 i rows, width 16, bottom 32-16, top 64-32-1, 13
numerical features), the same `ClickGenerator` stream (planted structure,
Bayes AUC about 0.85; seed + 1, power-law ids at alpha 1.05), the same
warmup / poly-decay schedule and sparse adagrad, with `evaluate` every
`eval_every` steps on the generator's steps from 1,000,000 on. Its tables
take the dense strategy under ``"auto"``, as in the JAX package.

    python -m distributed_embeddings_tpu_torch.tools.convergence_demo \\
        --steps 1500 --out convergence.json [--device cpu]
"""

import argparse
import json

__all__ = ["run", "TABLE_SIZES"]

TABLE_SIZES = [100 + 137 * i for i in range(26)]


def run(steps=2000, batch=512, eval_every=250, eval_steps=8, lr=0.08,
        seed=0, log_fn=print, device=None):
    """Train and evaluate; returns the record the JAX tool writes (the
    model, the first and last 100 losses' means, the AUC curve)."""
    import torch
    from distributed_embeddings_tpu_torch import training
    from distributed_embeddings_tpu_torch.models.dlrm import (
        DLRM, make_lr_schedule)
    from distributed_embeddings_tpu_torch.models.synthetic import (
        ClickGenerator)
    from distributed_embeddings_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    model = DLRM(TABLE_SIZES, embedding_dim=16, bottom_mlp_dims=(32, 16),
                 top_mlp_dims=(64, 32, 1), num_numerical_features=13,
                 device=device,
                 generator=torch.Generator(device=device).manual_seed(seed))
    gen = ClickGenerator(TABLE_SIZES, 13, batch, alpha=1.05, seed=seed + 1)
    schedule = make_lr_schedule(lr, warmup_steps=max(steps // 20, 1),
                                decay_start_step=steps // 2,
                                decay_steps=max(steps // 2, 1))
    _, _, hist = training.fit(
        model, gen, steps=steps, optimizer="adagrad", lr=schedule,
        sparse=True, eval_data=lambda j: gen.batch(1_000_000 + j),
        eval_every=eval_every, eval_steps=eval_steps,
        log_every=max(eval_every // 2, 1), log_fn=log_fn)
    first, last = hist["loss"][:100], hist["loss"][-100:]
    return {
        "model": {"tables": len(TABLE_SIZES),
                  "vocab_total": sum(TABLE_SIZES), "embedding_dim": 16,
                  "batch": batch, "steps": steps, "optimizer": "adagrad",
                  "lr": lr, "alpha": 1.05},
        "loss_first100_mean": float(sum(first) / max(len(first), 1)),
        "loss_last100_mean": float(sum(last) / max(len(last), 1)),
        "eval_auc": [round(a, 5) for a in hist.get("eval_auc", [])],
        "eval_every": eval_every,
    }


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--batch", type=int, default=512)
    p.add_argument("--eval_every", type=int, default=250)
    p.add_argument("--eval_steps", type=int, default=8)
    p.add_argument("--lr", type=float, default=0.08)
    p.add_argument("--device", default=None,
                   help="where to run (default: the card)")
    p.add_argument("--out", default=None)
    args = p.parse_args()
    result = run(args.steps, args.batch, args.eval_every, args.eval_steps,
                 args.lr, device=args.device)
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
