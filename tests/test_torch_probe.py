"""The Hopper feature ladder's plain rungs against the TPU probe's rungs.

``tools/tpu_mosaic_probe.py`` is loaded from its path, unedited. Each of
its seven ``pl.pallas_call`` rungs runs in interpret mode through a
monkeypatched ``pallas_call`` that records the inputs and output of the
call; the port's rung (its plain version, on CPU tensors) on the same
inputs is held bit-equal to the output. On the seeded distinct-row inputs
each plain rung is held bit-equal to a numpy expression and to the TPU
rung's own kernel, run again in interpret mode on those inputs. Rungs 8-9
against ``pallas_scatter`` and ``pallas_tiled`` in interpret mode at the
TPU rungs' inputs: the scatter and the gather bit-equal; sgd, adagrad and
adam at rtol 1e-5 / atol 1e-6 (the one-hot matmuls sum duplicate rows in
another order, the tiled kernels' float32 parity class); a fresh process's
first threaded CPU adam step bit-equal to the step on one thread. Then the
ladder itself: every rung ok on the CPU, a failed rung reported with the others
still run, and the compiler-log reading of ``kernel_build``.
"""

import functools
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from distributed_embeddings_tpu.ops import pallas_scatter as jax_scatter  # noqa: E402
from distributed_embeddings_tpu.ops import pallas_tiled as jax_tiled  # noqa: E402
from distributed_embeddings_tpu_torch.ops import cuda_sparse, cuda_tiled  # noqa: E402
from distributed_embeddings_tpu_torch.ops import kernel_build  # noqa: E402
from distributed_embeddings_tpu_torch.tools import cuda_feature_probe as port  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TILED_TOL = dict(rtol=1e-5, atol=1e-6)
KERNEL_RUNGS = list(port.KERNEL_RUNGS)


@pytest.fixture(scope="module")
def probe():
    path = os.path.join(REPO, "tools", "tpu_mosaic_probe.py")
    spec = importlib.util.spec_from_file_location("tpu_mosaic_probe", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run_recorded(probe, monkeypatch, rung):
    """Run the TPU probe's `rung_<rung>` with every pallas_call in
    interpret mode; returns [(inputs, output, kernel, kwargs)] per call."""
    real = probe.pl.pallas_call
    calls = []

    def pallas_call(kernel, **kwargs):
        call = real(kernel, interpret=True, **kwargs)

        def run(*args):
            out = call(*args)
            calls.append(([np.asarray(a) for a in args], np.asarray(out),
                          kernel, kwargs))
            return out
        return run

    monkeypatch.setattr(probe.pl, "pallas_call", pallas_call)
    getattr(probe, f"rung_{rung}")()
    monkeypatch.undo()
    assert len(calls) == 1
    return calls[0], real


def _port_rung(rung, arrays):
    """The port's rung through its wrapper on CPU tensors (the plain
    version), on copies of `arrays`; no kernel launch."""
    before = dict(port.launches)
    out = port.KERNEL_RUNGS[rung][1](*[torch.from_numpy(a.copy())
                                       for a in arrays])
    assert port.launches == before
    return out.numpy()


@pytest.mark.parametrize("rung", KERNEL_RUNGS)
def test_plain_rung_equals_the_tpu_rung(probe, monkeypatch, rung):
    """On the TPU rung's own inputs, which `rung_inputs(.., "jax")`
    reproduces, the port's rung is bit-equal to the Pallas kernel."""
    (inputs, want, _, _), _ = _run_recorded(probe, monkeypatch, rung)
    ours = port.rung_inputs(rung, "jax")
    assert len(ours) == len(inputs)
    for a, b in zip(ours, inputs):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    got = _port_rung(rung, inputs)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert got[0, 0] == port.KERNEL_RUNGS[rung][3]


def _blockspec_numpy(tof, cof, ids, hp, table):
    acc = np.zeros(port.TILE, np.float32)
    for t, c in zip(tof, cof):
        local = ids[c] - t * port.TILE
        counts = (np.arange(port.TILE)[:, None] == local[None, :]).sum(1)
        acc = acc + counts.astype(np.float32) * hp.reshape(-1)[0]
    out = table.copy()
    rows = slice(tof[-1] * port.TILE, (tof[-1] + 1) * port.TILE)
    out[rows] = table[rows] + acc[:, None]
    return out


NUMPY_RUNGS = {
    "vmem": lambda x: x * np.float32(2),
    "anyspace": lambda t: np.zeros((port.B, port.W), np.float32),
    "dma": lambda t: t[:port.B],
    "dyn_dma": lambda idx, t: t[idx[:1]],
    "prefetch": lambda ids, t: t[ids],
    "loop_dma": lambda idx, t: functools.reduce(np.add, t[idx])[None],
    "blockspec_gather": _blockspec_numpy,
}


@pytest.mark.parametrize("rung", KERNEL_RUNGS)
def test_plain_rung_on_distinct_rows(probe, monkeypatch, rung):
    """On seeded inputs over t[r, c] = r * 128 + c the port's rung is
    bit-equal to a numpy expression and to the TPU rung's kernel run on
    the same inputs; and those inputs tell every row apart."""
    args = port.rung_inputs(rung, "distinct")
    table = args[-1]
    assert len(np.unique(table)) == table.size
    assert np.array_equal(table, np.arange(table.size, dtype=np.float32)
                          .reshape(table.shape))
    got = _port_rung(rung, args)
    want = NUMPY_RUNGS[rung](*[a.copy() for a in args])
    assert np.array_equal(got, want)
    (_, _, kernel, kwargs), real = _run_recorded(probe, monkeypatch, rung)
    tpu = np.asarray(real(kernel, interpret=True, **kwargs)(
        *[jnp.asarray(a) for a in args]))
    assert np.array_equal(got, tpu)
    if rung == "blockspec_gather":
        tof = args[0]
        changed = np.flatnonzero((got != table).any(axis=1))
        assert tof[0] != tof[-1] and changed.size > 0
        assert set(changed) <= set(range(tof[-1] * port.TILE,
                                         (tof[-1] + 1) * port.TILE))


@pytest.mark.parametrize("rung,bad", [
    ("dyn_dma", lambda a: [np.asarray([port.V], np.int32), a[1]]),
    ("prefetch", lambda a: [np.asarray([0, -1, 2, 3], np.int32), a[1]]),
    ("loop_dma", lambda a: [np.arange(9, dtype=np.int32), a[1]]),
    ("blockspec_gather", lambda a: [np.asarray([0, 4], np.int32), *a[1:]]),
    ("blockspec_gather", lambda a: [a[0], np.asarray([0, 2], np.int32),
                                    *a[2:]]),
])
def test_rung_refuses_what_the_kernel_does_not_take(rung, bad):
    """A row, tile or chunk out of range (which traps on the card), or more
    rows in flight than the kernel has slots, raises on the CPU."""
    args = [torch.from_numpy(a) for a in bad(port.rung_inputs(rung))]
    with pytest.raises((IndexError, ValueError, RuntimeError)):
        port.KERNEL_RUNGS[rung][1](*args)


def test_rmw_scatter_rung_equals_the_tpu_scatter():
    """Rung 8: `sgd_rows` at lr -1 bit-equal to `scatter_add_sorted_unique`
    in interpret mode, at the TPU rung's inputs."""
    table, ids, delta = port.rmw_scatter_inputs()
    got = cuda_sparse.sgd_rows(torch.from_numpy(table.copy()),
                               torch.from_numpy(ids), torch.from_numpy(delta),
                               -1.0).numpy()
    want = np.asarray(jax_scatter.scatter_add_sorted_unique(
        jnp.asarray(table), jnp.asarray(ids), jnp.asarray(delta),
        interpret=True))
    assert np.array_equal(got, want)
    scattered = table.copy()
    scattered[ids] += delta
    assert np.array_equal(got, scattered)


@pytest.mark.parametrize("kind", ["gather", "sgd", "adagrad", "adam"])
def test_tiled_kernels_rung_matches_pallas_tiled(kind):
    """Rung 9 at `_validate_tiled`'s inputs: the port's tiled gather and
    raw-stream updates against `pallas_tiled` in interpret mode."""
    ids, delta, table = port.tiled_inputs()
    t, i, d = (torch.from_numpy(a.copy()) for a in (table, ids, delta))
    jt, ji, jd = (jnp.asarray(a) for a in (table, ids, delta))
    if kind == "gather":
        got = [cuda_tiled.tiled_gather(t, i)]
        want = [jax_tiled.tiled_gather(jt, ji, interpret=True)]
    elif kind == "sgd":
        got = [cuda_tiled.tiled_sgd(t, i, d, 0.05)]
        want = [jax_tiled.tiled_sgd(jt, ji, jd, 0.05, interpret=True)]
    elif kind == "adagrad":
        acc = np.full(table.shape, 0.1, np.float32)
        got = cuda_tiled.tiled_adagrad(t, torch.from_numpy(acc.copy()), i,
                                       d, 0.05)
        want = jax_tiled.tiled_adagrad(jt, jnp.asarray(acc), ji, jd, 0.05,
                                       interpret=True)
    else:
        zeros = np.zeros_like(table)
        got = cuda_tiled.tiled_adam(t, torch.from_numpy(zeros.copy()),
                                    torch.from_numpy(zeros.copy()), 0, i, d,
                                    0.01)
        want = jax_tiled.tiled_adam(jt, jnp.asarray(zeros),
                                    jnp.asarray(zeros),
                                    jnp.zeros((), jnp.int32), ji, jd, 0.01,
                                    interpret=True)
        assert got[3] == int(want[3]) == 1
        got, want = got[:3], want[:3]
    for g, w in zip(got, want):
        if kind == "gather":
            assert np.array_equal(g.numpy(), np.asarray(w))
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TILED_TOL)


FIRST_THREADED_ADAM = """
import numpy as np, torch
from distributed_embeddings_tpu_torch.ops import cuda_tiled
from distributed_embeddings_tpu_torch.tools import cuda_feature_probe as port
ids, delta, table = port.tiled_inputs()
def step():
    zeros = np.zeros_like(table)
    return cuda_tiled.tiled_adam(
        *(torch.from_numpy(a.copy()) for a in (table, zeros, zeros)), 0,
        torch.from_numpy(ids), torch.from_numpy(delta), 0.01)[0]
torch.set_num_threads(8)
first = step()
torch.set_num_threads(1)
print(int((first != step()).sum()))
"""


def test_first_threaded_cpu_adam_step_equals_one_thread():
    """The process's first CPU adam step (the first ``torch.sqrt``) on 8
    intra-op threads is bit-equal to the step on one thread. Without the
    port's `settle_cpu_vector_math` at import, about one fresh process in
    ten has one thread's block of the table off by up to 3e-4 of the step;
    four processes run at once."""
    procs = [subprocess.Popen([sys.executable, "-c", FIRST_THREADED_ADAM],
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    results = [p.communicate(timeout=120) + (p.returncode,) for p in procs]
    assert [r[2] for r in results] == [0] * 4, [r[1] for r in results]
    assert [int(r[0].split()[-1]) for r in results] == [0] * 4


def test_ladder_runs_every_rung_on_the_cpu(capsys):
    """`run_ladder` on the CPU (the plain versions): nine rungs in order,
    all ok; `main` prints a line per rung and the matrix, and returns 0."""
    matrix = port.run_ladder("cpu")
    assert [e["rung"] for e in matrix] == KERNEL_RUNGS + ["rmw_scatter",
                                                          "tiled_kernels"]
    assert all(e["ok"] and e["max_abs_err"] == 0.0 for e in matrix), matrix
    assert all(e["build_s"] is None for e in matrix)
    assert port.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith("nvcc: ")
    assert sum(line.startswith("ok   ") for line in out) == 9
    assert [e["rung"] for e in json.loads(out[-1])] == [e["rung"]
                                                        for e in matrix]


def test_a_failed_rung_fails_alone_and_main_returns_1(monkeypatch, capsys):
    def broken(device):
        raise RuntimeError("injected fault")

    rungs = list(port.RUNGS)
    monkeypatch.setattr(port, "RUNGS", rungs[:3] + [
        port.Rung("broken", "probe_vmem", broken)] + rungs[3:])
    matrix = port.run_ladder("cpu")
    assert [e["rung"] for e in matrix][3] == "broken"
    failed = [e for e in matrix if not e["ok"]]
    assert [e["rung"] for e in failed] == ["broken"]
    assert "injected fault" in failed[0]["error"]
    assert port.main(["--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "FAIL broken: RuntimeError: injected fault" in out
    assert out.count("ok   ") == 9


def test_ladder_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        port.run_ladder()


def test_library_is_named_by_flags_and_its_log_sits_beside_it(monkeypatch):
    """Flags are part of a library's name (a new flag rebuilds); nvcc runs
    with -Xptxas -v; the compiler log is the library's name with .log."""
    assert kernel_build.NVCC_FLAGS[-2:] == ("-Xptxas", "-v")
    before = kernel_build.library_path("probe_vmem")
    monkeypatch.setattr(kernel_build, "NVCC_FLAGS",
                        kernel_build.NVCC_FLAGS + ("-lineinfo",))
    after = kernel_build.library_path("probe_vmem")
    assert after != before
    assert os.path.dirname(after) == os.path.dirname(before)
    log = kernel_build.log_path("probe_vmem")
    assert os.path.dirname(log) == os.path.dirname(after)
    assert log == after[:-len(".so")] + ".log"


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z11vmem_kernelPKflPf' for 'sm_90a'
ptxas info    : Function properties for _Z11vmem_kernelPKflPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 12 registers, used 1 barriers, 16384 bytes smem, 376 bytes cmem[0]
ptxas info    : Compiling entry function '_Z5otherv' for 'sm_90a'
ptxas info    : Function properties for _Z5otherv
    24 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 255 registers, 360 bytes cmem[0]
"""


def test_ptxas_usage_reads_the_compiler_log(monkeypatch, tmp_path):
    monkeypatch.setattr(kernel_build, "BUILD_DIR", str(tmp_path))
    with open(kernel_build.log_path("probe_vmem"), "w") as f:
        f.write(PTXAS_LOG)
    assert kernel_build.ptxas_usage("probe_vmem") == {
        "_Z11vmem_kernelPKflPf": dict(registers=12, shared_bytes=16384,
                                      spill_bytes=0),
        "_Z5otherv": dict(registers=255, shared_bytes=0, spill_bytes=12)}
