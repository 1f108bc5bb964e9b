"""Criteo-Kaggle end to end with the on-the-fly vocabulary (IntegerLookup).

Counterpart of ``examples/criteo/main.py``: raw categorical keys -> one
`IntegerLookup` per feature (the host's C++ map; the vocabulary is built
while training) -> one combiner-less ``Embedding(max_tokens + 1, 128)``
per feature -> an MLP over the numerical features and the 26 embeddings ->
a logit, trained with the dense adam twin (`training.adam`). The lookup
and the staging to the card run in the ingest pipeline's workers
(`utils.pipeline.IngestPipeline`; ``--serial_ingest`` runs them inline,
`SerialPipeline`), so the host hash overlaps the step.

    python -m distributed_embeddings_tpu_torch.tools.criteo_example \\
        --synthetic --steps 50 [--device cpu]
    python -m distributed_embeddings_tpu_torch.tools.criteo_example \\
        --csv train.txt --steps 200
    python -m distributed_embeddings_tpu_torch.tools.criteo_example \\
        --bench_lookup --bench_lookup_keys 16777216 --max_tokens 20000000

The pieces are exposed for callers that hold the flow against another:
`CriteoModel` (``params_from_numpy`` takes the JAX example's parameter
tree as numpy), `make_step`, `make_lookups`, `lookup_stage`, `train` and
`bench_lookup`.
"""

import argparse
import csv
import itertools
import json
import time
from typing import Callable, List, Optional

import numpy as np
import torch
from torch import nn

from distributed_embeddings_tpu_torch import training
from distributed_embeddings_tpu_torch.layers.embedding import (Embedding,
                                                             IntegerLookup)
from distributed_embeddings_tpu_torch.models.dlrm import MLP
from distributed_embeddings_tpu_torch.parallel.staging import (DeviceStager,
                                                               ready)
from distributed_embeddings_tpu_torch.utils.device import (default_generator,
                                                           resolve_device)
from distributed_embeddings_tpu_torch.utils.pipeline import (IngestPipeline,
                                                             SerialPipeline)

__all__ = ["parse_args", "csv_batches", "synthetic_batches", "CriteoModel",
           "make_lookups", "lookup_stage", "make_step", "train",
           "bench_lookup", "main"]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--csv", default=None,
                   help="Criteo Kaggle train.txt (tab-separated)")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--bench_lookup", action="store_true",
                   help="microbenchmark native vs numpy IntegerLookup")
    p.add_argument("--bench_lookup_keys", type=int, default=1 << 20,
                   help="total keys for --bench_lookup")
    p.add_argument("--bench_lookup_batch", type=int, default=65536,
                   help="keys per lookup call in --bench_lookup")
    p.add_argument("--batch_size", type=int, default=4096)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--max_tokens", type=int, default=100000,
                   help="IntegerLookup capacity per feature")
    p.add_argument("--embedding_dim", type=int, default=128)
    p.add_argument("--mlp", default="512,256,1")
    p.add_argument("--num_categorical", type=int, default=26)
    p.add_argument("--num_numerical", type=int, default=13)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--serial_ingest", action="store_true",
                   help="run the IntegerLookup hash and the staging inline "
                        "in the consumer thread instead of the ingest "
                        "pipeline's workers")
    p.add_argument("--pipeline_depth", type=int, default=2)
    p.add_argument("--device", default="cuda",
                   help="where the model trains (default: the card)")
    p.add_argument("--force_cpu", action="store_const", const="cpu",
                   dest="device", help="the same as --device cpu")
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def csv_batches(path, batch_size, n_num, n_cat):
    """Yield (numerical, raw_keys, labels) from the Kaggle TSV format:
    label \\t 13 ints \\t 26 hex strings."""
    with open(path) as f:
        reader = csv.reader(f, delimiter="\t")
        while True:
            rows = list(itertools.islice(reader, batch_size))
            if len(rows) < batch_size:
                return
            labels = np.array([[float(r[0])] for r in rows], np.float32)
            numerical = np.array(
                [[float(x) if x else 0.0 for x in r[1:1 + n_num]]
                 for r in rows], np.float32)
            raw = np.array(
                [[int(x, 16) if x else -1
                  for x in r[1 + n_num:1 + n_num + n_cat]]
                 for r in rows], np.int64)
            yield numerical, raw, labels


def synthetic_batches(batch_size, n_num, n_cat, seed):
    """Yield (numerical, raw_keys, labels): zipf(1.3) keys times
    2654435761 (a hex-hash-like sparse key space; the product wraps in
    int64 as numpy wraps it)."""
    rng = np.random.RandomState(seed)
    while True:
        numerical = rng.rand(batch_size, n_num).astype(np.float32)
        raw = rng.zipf(1.3, size=(batch_size, n_cat)).astype(
            np.int64) * 2654435761
        labels = rng.randint(0, 2, (batch_size, 1)).astype(np.float32)
        yield numerical, raw, labels


class CriteoModel(nn.Module):
    """One combiner-less `Embedding` of ``max_tokens + 1`` rows per
    feature (`tables`) and one `MLP` (`mlp`) over ``[numerical, emb_0, ..,
    emb_{n_cat - 1}]``; the logit is the MLP's one output. The tables take
    the `Embedding` default initializer and the MLP the JAX package's,
    all drawn in turn from one generator seeded with `seed`."""

    def __init__(self, n_cat: int = 26, max_tokens: int = 100000,
                 embedding_dim: int = 128, mlp_dims=(512, 256, 1),
                 n_num: int = 13, device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        gen = default_generator(device, seed=seed)
        self.tables = nn.ModuleList([
            Embedding(max_tokens + 1, embedding_dim, device=device,
                      generator=gen) for _ in range(n_cat)])
        self.mlp = MLP(list(mlp_dims), n_num + n_cat * embedding_dim,
                       device, gen)

    def forward(self, numerical, idx):
        device = self.mlp[0].w.device
        idx = torch.as_tensor(idx, device=device)
        embs = [t(idx[:, i]) for i, t in enumerate(self.tables)]
        x = torch.cat([torch.as_tensor(numerical, device=device)] + embs,
                      dim=1)
        return self.mlp(x)[:, 0]

    def loss_fn(self, numerical, idx, labels):
        """The mean sigmoid cross-entropy, as the JAX example writes it."""
        logits = self(numerical, idx)
        y = torch.as_tensor(labels, device=logits.device).reshape(-1)
        return torch.mean(torch.clamp_min(logits, 0) - logits * y
                          + torch.log1p(torch.exp(-logits.abs())))

    def params_from_numpy(self, params: dict) -> None:
        """Load the JAX example's parameter tree (numpy leaves):
        ``{"tables": [{"embeddings": [V, w]}], "mlp": [{"w", "b"}]}``."""
        state = {}
        for i, t in enumerate(params["tables"]):
            state[f"tables.{i}.embeddings"] = torch.from_numpy(
                np.array(t["embeddings"], np.float32))
        for i, layer in enumerate(params["mlp"]):
            for k in ("w", "b"):
                state[f"mlp.{i}.{k}"] = torch.from_numpy(
                    np.array(layer[k], np.float32))
        self.load_state_dict(state)


def make_lookups(n_cat: int, max_tokens: int,
                 use_native: Optional[bool] = None) -> list:
    """One `IntegerLookup` of `max_tokens` per feature."""
    return [IntegerLookup(max_tokens, use_native=use_native)
            for _ in range(n_cat)]


def lookup_stage(lookups: list) -> Callable:
    """The pipeline's ``lookup`` stage: (numerical, raw keys [B, n_cat],
    labels) -> (numerical, indices [B, n_cat] int32, labels), each
    feature's keys through its `IntegerLookup`, the int64 indices cast to
    int32 into one feature-stacked matrix."""
    def lookup_batch(batch):
        numerical, raw, labels = batch
        idx = np.empty((raw.shape[0], len(lookups)), np.int32)
        for j, lk in enumerate(lookups):
            idx[:, j] = lk(raw[:, j])
        return numerical, idx, labels
    return lookup_batch


def make_step(lr: float = 1e-3):
    """(optimizer, step): the dense adam twin at `lr` and
    ``step(model, opt_state, numerical, idx, labels) -> (model, opt_state,
    loss)``, the gradient of every parameter, tables included
    (`training.make_train_step`)."""
    opt = training.adam(lr)
    return opt, training.make_train_step(
        lambda model, *batch: model.loss_fn(*batch), opt)


def train(model, lookups: list, batches, steps: int, lr: float = 1e-3,
          serial: bool = False, depth: int = 2, log_every: int = 20,
          log_fn=print, opt_state=None, callbacks=()) -> dict:
    """`steps` adam steps over `batches` (raw-key batches), the lookup and
    the staging in the ingest pipeline (inline with `serial`). Returns
    ``{"losses", "seconds", "stage_ms", "opt_state", "vocab"}``: the
    losses as floats (read after the last step, so no step waits for its
    loss), the wall seconds of the loop, each stage's mean ms, the
    optimizer state and each lookup's size. Each callback's
    ``on_step(i, model, loss)`` runs after step i (`fit`'s callbacks)."""
    opt, step = make_step(lr)
    if opt_state is None:
        opt_state = opt.init(dict(model.named_parameters()))
    device = model.mlp[0].w.device
    stages = [("lookup", lookup_stage(lookups)),
              ("stage", DeviceStager(device).stage)]
    source = itertools.islice(iter(batches), steps)
    pipe = (SerialPipeline(source, stages) if serial
            else IngestPipeline(source, stages, depth=depth))
    losses: List[torch.Tensor] = []
    t0 = time.perf_counter()
    try:
        for i, batch in enumerate(pipe):
            numerical, idx, labels = ready(batch)
            model, opt_state, loss = step(model, opt_state, numerical, idx,
                                          labels)
            losses.append(loss)
            for cb in callbacks:
                cb.on_step(i, model, loss)
            if log_every and i % log_every == 0:
                log_fn(f"step {i}: loss={float(loss):.5f} "
                       f"vocab={sum(lk.size for lk in lookups)} keys")
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds = time.perf_counter() - t0
    finally:
        pipe.close()
    return {"losses": [float(x) for x in losses], "seconds": seconds,
            "stage_ms": {k: v["mean_ms"]
                         for k, v in pipe.stage_summaries().items()},
            "opt_state": opt_state, "vocab": [lk.size for lk in lookups]}


def bench_lookup(total_keys: int, batch: int, max_tokens: int,
                 num_categorical: int = 26, log_fn=print) -> dict:
    """Native against numpy `IntegerLookup` on duplicate-heavy power-law
    keys (zipf 1.2, times 2654435761 mod 2^40), batch by batch after a
    warm batch. The numpy arm runs at most 2^21 keys (rates, not totals,
    are compared). Returns the JAX example's record."""
    rng = np.random.RandomState(0)
    nb = max(2, -(-total_keys // batch))
    keys = (rng.zipf(1.2, size=(nb, batch)) * 2654435761 % (1 << 40)
            ).astype(np.int64)
    rec = {"total_keys": int((nb - 1) * batch), "batch": batch,
           "max_tokens": max_tokens, "zipf_alpha": 1.2,
           "unique_keys": int(np.unique(keys[1:]).size)}
    numpy_nb = min(nb, max(2, (1 << 21) // batch))
    for use_native, label, arm_nb in ((True, "native", nb),
                                      (False, "numpy", numpy_nb)):
        lk = IntegerLookup(max_tokens, use_native=use_native)
        lk(keys[0])
        t0 = time.perf_counter()
        for i in range(1, arm_nb):
            lk(keys[i])
        dt = time.perf_counter() - t0
        rate = (arm_nb - 1) * batch / dt
        rec[f"{label}_keys_per_sec"] = rate
        rec[f"{label}_measured_keys"] = int((arm_nb - 1) * batch)
        rec[f"{label}_vocab_after"] = int(lk.size)
        # one hashed key per categorical feature per sample
        rec[f"{label}_samples_per_sec_bound"] = rate / num_categorical
        log_fn(f"IntegerLookup[{label}]: {rate:,.0f} keys/sec over "
               f"{(arm_nb - 1) * batch:,} keys (vocab {lk.size}; implies "
               f"<= {rate / num_categorical:,.0f} samples/sec at "
               f"{num_categorical} cat features)")
        del lk
    return rec


def main(argv=None):
    args = parse_args(argv)
    n_cat, n_num = args.num_categorical, args.num_numerical
    if args.bench_lookup:
        rec = bench_lookup(args.bench_lookup_keys, args.bench_lookup_batch,
                           args.max_tokens, n_cat)
        print(json.dumps({"bench_lookup": rec}), flush=True)
        return rec
    lookups = make_lookups(n_cat, args.max_tokens)
    print("IntegerLookup backend: native C++", flush=True)
    model = CriteoModel(
        n_cat, args.max_tokens, args.embedding_dim,
        [int(x) for x in args.mlp.split(",")], n_num, device=args.device,
        seed=args.seed)
    if args.csv:
        batches = csv_batches(args.csv, args.batch_size, n_num, n_cat)
    else:
        batches = synthetic_batches(args.batch_size, n_num, n_cat, args.seed)
    out = train(model, lookups, batches, args.steps, lr=args.lr,
                serial=args.serial_ingest, depth=args.pipeline_depth,
                log_fn=lambda m: print(m, flush=True))
    n = len(out["losses"])
    print(f"done: {n} steps in {out['seconds']:.1f}s "
          f"({n * args.batch_size / out['seconds']:,.0f} samples/sec); "
          f"ingest stages mean ms: {out['stage_ms']}; "
          f"final vocab sizes: {out['vocab'][:4]}...", flush=True)
    return out


if __name__ == "__main__":
    main()
