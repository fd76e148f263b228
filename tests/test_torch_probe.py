"""P1 and P2, the toolchain probe of tools/pallas_smoke.py: the plain
versions against the script's own kernel bodies (`kernel`, `k2`, read
from the script with ast and run through pl.pallas_call in interpret
mode with the script's specs), csrc/probe.cu on CPU threads against the
plain versions, mutants of the source that the cases catch, the routers
and the probe's entry point.

The script itself is not imported: its module body launches its
pallas_calls.  The cases are `chip_smoke.P1_CASES` / `P2_CASES`, which
chip_smoke.py also runs on the card.
"""

import ast
import concurrent.futures
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import chip_smoke
import cuda_threads
from tpuh264_torch.kernels import cuda_lib, probe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "tools", "pallas_smoke.py")
CSRC = os.path.join(os.path.dirname(cuda_lib.__file__), os.pardir, "csrc")
JAX_P2 = [c for c in chip_smoke.P2_CASES if c[1][0] % 8 == 0
          and c[1][1] == 128]
# (name, kernel, text of csrc/probe.cu, its replacement)
MUTANTS = [
    ("arithmetic shift", "bits",
     "const uint32_t r = (u >> sh) |",
     "const uint32_t r = (uint32_t)((int)u >> sh) |"),
    ("unsigned compare", "bits", "((int)u > 5 ? 1u : 0u)",
     "(u > 5u ? 1u : 0u)"),
    ("a slab skipped", "slab", "constexpr int kSlabs = 16;",
     "constexpr int kSlabs = 15;"),
]


def _script_bodies():
    """`kernel` and `k2` of tools/pallas_smoke.py, compiled from their ast
    alone (the module body around them launches pallas_calls)."""
    ns = {"jax": jax, "jnp": jnp}
    tree = ast.parse(open(SCRIPT).read())
    defs = [n for n in tree.body if isinstance(n, ast.FunctionDef)]
    assert [d.name for d in defs] == ["kernel", "k2"]
    exec(compile(ast.Module(defs, []), SCRIPT, "exec"), ns)
    return ns["kernel"], ns["k2"]


KERNEL, K2 = _script_bodies()


def _jax_p1(x: np.ndarray) -> np.ndarray:
    """The script's P1 call (the whole array in VMEM), interpreted."""
    return np.asarray(pl.pallas_call(
        KERNEL, out_shape=jax.ShapeDtypeStruct(x.shape, jnp.int32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True)(x))


def _jax_p2(lv: np.ndarray) -> np.ndarray:
    """The script's P2 call (a grid over M in blocks of (16, 8, 128)),
    interpreted."""
    m = lv.shape[1]
    return np.asarray(pl.pallas_call(
        K2, grid=(m // 8,),
        in_specs=[pl.BlockSpec((16, 8, 128), lambda g: (0, g, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((8, 128), lambda g: (g, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((m, 128), jnp.int32),
        interpret=True)(lv))


def _p1(case):
    return chip_smoke.p1_case(np, case[0], case[1])


def _p2(case):
    return chip_smoke.p2_case(np, case[0], case[1])


@pytest.mark.parametrize("case", chip_smoke.P1_CASES, ids=str)
def test_p1_plain_equals_the_script_body(case):
    """_probe_bits_plain == the script's `kernel` (shifts, clz, signed
    compare, wrapping) on every case's values."""
    x = _p1(case)
    got = probe._probe_bits_plain(torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _jax_p1(x))


@pytest.mark.parametrize("case", JAX_P2, ids=str)
def test_p2_plain_equals_the_script_body(case):
    """_slab_sum_plain == the script's gridded `k2`, sums that wrap
    included."""
    lv = _p2(case)
    got = probe._slab_sum_plain(torch.from_numpy(lv))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _jax_p2(lv))


def test_probe_inputs_match_the_script_truths():
    """On the script's own inputs the plain versions equal its numpy
    truths (tools/pallas_smoke.py :25-31 and lv.sum(0)), and the port's
    copy of the first truth equals the script body on them."""
    x = np.arange(8 * 128, dtype=np.int32).reshape(8, 128)
    truth = probe.bits_truth(x)
    np.testing.assert_array_equal(truth, _jax_p1(x))
    np.testing.assert_array_equal(
        probe._probe_bits_plain(torch.from_numpy(x)).numpy(), truth)
    lv = np.arange(16 * 32 * 128, dtype=np.int32).reshape(16, 32, 128)
    np.testing.assert_array_equal(
        probe._slab_sum_plain(torch.from_numpy(lv)).numpy(), lv.sum(0))


def test_plain_clz_is_exact():
    """_clz32 at every power of two and its neighbours, against Python's
    bit_length."""
    v = sorted({(1 << k) + d for k in range(32) for d in (-1, 0, 1)
                if 1 <= (1 << k) + d < 1 << 32})
    got = probe._clz32(torch.tensor(v, dtype=torch.int64))
    assert got.tolist() == [32 - x.bit_length() for x in v]


@pytest.mark.parametrize("case", chip_smoke.P2_CASES, ids=str)
def test_p2_plain_is_the_wrapped_sum(case):
    """_slab_sum_plain is the exact sum mod 2^32 on every case, ragged
    ones included."""
    lv = _p2(case)
    want = (lv.astype(np.int64).sum(0) + 2**31) % 2**32 - 2**31
    np.testing.assert_array_equal(
        probe._slab_sum_plain(torch.from_numpy(lv)).numpy(), want)


@pytest.fixture(scope="module")
def builds(tmp_path_factory):
    """csrc/probe.cu (all but its launch entries) built with g++ against
    the shims, a block's 256 threads as fibers: P1's kernel and P2's, and
    each mutant's kernel, all builds at once.  {"source": {"bits": exe,
    "slab": exe}, mutant name: {its kernel: exe}}."""
    root = tmp_path_factory.mktemp("probe_cpu")
    text = open(os.path.join(CSRC, "probe.cu")).read()
    jobs = [("source", CSRC, "bits"), ("source", CSRC, "slab")]
    for name, kernel, old, new in MUTANTS:
        assert text.count(old) == 1, old
        d = root / name.replace(" ", "_")
        d.mkdir()
        (d / "probe.cu").write_text(text.replace(old, new))
        jobs.append((name, str(d), kernel))
    out = {}
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        for i, (name, csrc, kernel) in enumerate(jobs):
            d = root / f"build{i}"
            d.mkdir()
            out.setdefault(name, {})[kernel] = pool.submit(
                cuda_threads.build_entry, d, csrc, "probe.cu",
                f"{kernel}_args", f"{kernel}_kernel", "a.blocks", "kThreads")
    return {name: {k: f.result() for k, f in exes.items()}
            for name, exes in out.items()}


def _run(exe, x: torch.Tensor, n: int, cap: int) -> torch.Tensor:
    out = torch.empty(n, dtype=torch.int32)
    cuda_threads.run_entry(exe, [x], [out], [n, cap])
    return out


def _run_p1(exe, case) -> torch.Tensor:
    x = chip_smoke.offset_view(torch, _p1(case), case[2], "cpu")
    return _run(exe, x, x.numel(), case[3]).view(x.shape)


def _run_p2(exe, case) -> torch.Tensor:
    lv = chip_smoke.offset_view(torch, _p2(case), case[2], "cpu")
    return _run(exe, lv, lv[0].numel(), case[3]).view(lv.shape[1:])


@pytest.mark.parametrize("case", chip_smoke.P1_CASES, ids=str)
def test_p1_source_on_cpu_threads_equals_plain(builds, case):
    """P1's 16-byte chunks (kUnroll in flight), scalar tail and grid-stride
    loop equal the plain version: tails, fewer elements than a chunk,
    offset views, a grid of one block."""
    got = _run_p1(builds["source"]["bits"], case)
    want = probe._probe_bits_plain(torch.from_numpy(_p1(case)))
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("case", chip_smoke.P2_CASES, ids=str)
def test_p2_source_on_cpu_threads_equals_plain(builds, case):
    """P2's 16 slab loads a chunk, its scalar route (ragged M * L) and
    grid-stride loop equal the plain version, wrapping sums included."""
    got = _run_p2(builds["source"]["slab"], case)
    want = probe._slab_sum_plain(torch.from_numpy(_p2(case)))
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("mutant", MUTANTS, ids=lambda m: m[0])
def test_mutants_of_the_source_fail_a_case(builds, mutant):
    """An arithmetic shift for the logical one, an unsigned compare for
    the signed one and a slab skipped each differ from the plain version
    on some case."""
    name, kernel = mutant[:2]
    exe = builds[name][kernel]
    if kernel == "bits":
        cases, run, plain, make = (chip_smoke.P1_CASES, _run_p1,
                                   probe._probe_bits_plain, _p1)
    else:
        cases, run, plain, make = (chip_smoke.P2_CASES, _run_p2,
                                   probe._slab_sum_plain, _p2)
    caught = [c for c in cases
              if not torch.equal(run(exe, c), plain(torch.from_numpy(
                  make(c))))]
    assert caught, f"mutant '{name}' passed every case"


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    """CPU tensors never load the library or count a launch; a meta
    tensor raises rather than falling back; P2 takes 16 slabs only."""
    monkeypatch.setattr(cuda_lib, "load", lambda: pytest.fail("loaded"))
    n1, n2 = probe.probe_bits.launches, probe.slab_sum.launches
    x = torch.from_numpy(_p1(chip_smoke.P1_CASES[1]))
    lv = torch.from_numpy(_p2(chip_smoke.P2_CASES[2]))
    assert torch.equal(probe.probe_bits(x), probe._probe_bits_plain(x))
    assert torch.equal(probe.slab_sum(lv), probe._slab_sum_plain(lv))
    assert (probe.probe_bits.launches, probe.slab_sum.launches) == (n1, n2)
    with pytest.raises(ValueError):
        probe.probe_bits(x.to("meta"))
    with pytest.raises(ValueError):
        probe.slab_sum(lv.to("meta"))
    with pytest.raises(ValueError):
        probe.slab_sum(lv[:15])


def test_entry_point_on_the_cpu(capsys):
    """`main(["--device", "cpu"])` prints the script's two lines, True,
    and returns 0."""
    assert probe.main(["--device", "cpu"]) == 0
    assert capsys.readouterr().out.splitlines() == [
        "match: True", "grid sum match: True"]


def test_entry_point_takes_the_card_by_default(monkeypatch):
    """Without --device the probe takes the card; where there is none it
    raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        probe.main([])
