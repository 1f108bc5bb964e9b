"""How much of a segment-walk kernel's time a power-law stream's longest
segment costs, on the card.

The segment sum of the deduplicated-row update (`segment_sum_sorted`) and
the raw-stream updates (`sgd_stream`, ...) add each segment of a sorted
stream in sorted order. A power-law stream gives its hottest row one long
segment, whose order-forced chain of adds no other work can shorten. This
tool runs one training step of each route at full size twice, on power-law
ids (alpha 1.05, the smoke's batches) and on uniform ids of the same count
(alpha 0: the same N, short segments), captures the kernel's inputs in
each, and times the kernel on them:

  * `segment_sum_sorted`: full-size Tiny V3, adagrad, the gather-combine
    lookup and the deduplicated-row strategy (one call per bucket);
  * `sgd_stream`: full-size criteo, sgd, the tiled lookup and strategy.

    python -m distributed_embeddings_tpu_torch.tools.segment_tail

prints the card's name and power limit, then one JSON line per call:
N, width, unique rows, the longest segment, the kernel's device time (CUDA
graph replays), the SM clock read while it runs and ``chain_ms``, the
longest segment times 4 cycles (one dependent float add a row) at that
clock. Needs one card (about 9 GB of device memory).
"""

import json
import subprocess
import sys
import threading
from typing import Callable, List, Optional

import torch

from distributed_embeddings_tpu_torch.ops import cuda_sparse, cuda_tiled
from distributed_embeddings_tpu_torch.tools.cuda_feature_probe import graph_us

BATCH = 65536
POWER_LAW = 1.05
# cycles of one dependent float32 add: the chain a segment's sorted-order
# sum forces is one add a row in every column
ADD_CYCLES = 4


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def sm_clock_mhz(run: Callable[[], object]) -> Optional[float]:
    """The SM clock (MHz) nvidia-smi reads while `run()` is called over and
    over on the card; None when it gives no number."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    reader = threading.Thread(target=proc.wait)
    reader.start()
    while reader.is_alive():
        run()
        torch.cuda.synchronize()
    try:
        return float(proc.stdout.read().strip().splitlines()[0])
    except (ValueError, IndexError):
        return None


def chain_ms(longest: int, mhz: Optional[float]) -> Optional[float]:
    """The longest segment's order-forced chain of adds, in ms."""
    if not mhz:
        return None
    return longest * ADD_CYCLES / (mhz * 1e6) * 1e3


def segment_stats(starts: torch.Tensor):
    """(unique rows, longest segment) of a starts array."""
    lengths = starts[1:] - starts[:-1]
    return int((lengths > 0).sum().item()), int(lengths.max().item())


class _Capture:
    """Records the arguments of every call of ``module.name`` in the block
    (the call still runs)."""

    def __init__(self, module, name):
        self.module, self.name, self.calls = module, name, []

    def __enter__(self):
        self.real = getattr(self.module, self.name)

        def record(*args):
            self.calls.append(args)
            return self.real(*args)
        setattr(self.module, self.name, record)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def _step_calls(config, optimizer, strategy, lookup_path, module, name,
                alpha) -> List[tuple]:
    """The arguments `name` gets in one step of a fresh full-size model."""
    from distributed_embeddings_tpu_torch.models.synthetic import (
        InputGenerator, SyntheticModel)
    from distributed_embeddings_tpu_torch.training import (
        make_sparse_train_step)
    model = SyntheticModel(config, device="cuda", lookup_path=lookup_path,
                           generator=torch.Generator(device="cuda")
                           .manual_seed(0))
    init, step = make_sparse_train_step(model, optimizer, lr=0.01,
                                        strategy=strategy)
    state = init(model)
    num, cats, labels = InputGenerator(config, BATCH, alpha=alpha,
                                       num_batches=1, seed=0)[0]
    with _Capture(module, name) as cap:
        step(model, state, num, cats, labels)
    torch.cuda.synchronize()
    return cap.calls


def _report(kernel, config, alpha, call, rows, width, starts, run):
    unique, longest = segment_stats(starts)
    ms = graph_us(run, 3, 3) / 1e3
    mhz = sm_clock_mhz(run)
    print(json.dumps(dict(
        kernel=kernel, config=config, alpha=alpha, call=call, rows=rows,
        width=width, unique_rows=unique, longest_segment=longest, ms=ms,
        sm_clock_mhz=mhz, chain_ms=chain_ms(longest, mhz))), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("segment_tail: no CUDA device", file=sys.stderr)
        return 2
    from distributed_embeddings_tpu_torch.models.synthetic import (
        SYNTHETIC_MODELS)
    print(card_line(), flush=True)
    for alpha in (POWER_LAW, 0.0):
        calls = _step_calls(SYNTHETIC_MODELS["tiny"], "adagrad", "auto",
                            "auto", cuda_sparse, "segment_sum_sorted", alpha)
        for c, (contribs, perm, starts) in enumerate(calls):
            _report("segment_sum_sorted", "tiny", alpha, c, contribs.shape[0],
                    contribs.shape[1], starts,
                    lambda: cuda_sparse.segment_sum_sorted(contribs, perm,
                                                           starts))
        del calls
        torch.cuda.empty_cache()
    for alpha in (POWER_LAW, 0.0):
        calls = _step_calls(SYNTHETIC_MODELS["criteo"], "sgd", "tiled",
                            "tiled", cuda_tiled, "sgd_stream", alpha)
        for c, (table, contribs, sid, perm, starts, lr) in enumerate(calls):
            _report("sgd_stream", "criteo", alpha, c, contribs.shape[0],
                    contribs.shape[1], starts,
                    lambda: cuda_tiled.sgd_stream(table, contribs, sid, perm,
                                                  starts, lr))
        del calls
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
