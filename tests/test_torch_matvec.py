"""PyTorch port vs the JAX package: the matvec probes' plain versions
(``ops/matvec.py``) against the Pallas kernels ``pallas_mv`` and
``pallas_mv_kt`` of ``benchmarks/matvec_probe.py`` in interpret mode, and
the wrappers' CPU routing and checks.  The CUDA kernels themselves are
tested on the card by tests/test_torch_cuda.py.

The probe is a script that calls ``pl.pallas_call`` without ``interpret``,
which the CPU backend refuses; the tests load it from its file and, for the
duration of a test, give its ``pl.pallas_call`` ``interpret=True``.
Tolerances: float32 atol 1e-5 with weights scaled by K^-0.5 (summation
order only); bfloat16 ``2e-3 + 1.6e-2 * |ref|`` (both round a float32 sum to
bf16 and may land one ulp apart), and for ``pallas_mv_kt`` in bf16 the bound
that its docstring derives.
"""
import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes; several xdist workers share the host

import jax.numpy as jnp  # noqa: E402

from qwen3tts_tpu_torch.ops import matvec as TM  # noqa: E402

PROBE = Path(__file__).resolve().parent.parent / "benchmarks" / "matvec_probe.py"
TOL = {"float32": (1e-5, 0.0), "bfloat16": (2e-3, 1.6e-2)}
K, N = 256, 1024


@pytest.fixture(scope="module")
def probe_module():
    spec = importlib.util.spec_from_file_location("matvec_probe", PROBE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture()
def probe(probe_module, monkeypatch):
    monkeypatch.setattr(probe_module.pl, "pallas_call",
                        functools.partial(probe_module.pl.pallas_call, interpret=True))
    return probe_module


def _inputs(dtype, seed):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((K, N)) * K ** -0.5).astype(np.float32)
    x = rng.standard_normal((1, K)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    wt = np.ascontiguousarray(w.T)
    return ((jnp.asarray(x).astype(jd), jnp.asarray(w).astype(jd), jnp.asarray(wt).astype(jd)),
            (torch.from_numpy(x).to(td), torch.from_numpy(w).to(td),
             torch.from_numpy(wt).to(td)))


def _close(got: torch.Tensor, want, dtype: str):
    atol, rtol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bn", [128, 512])
def test_matvec_plain_matches_pallas_mv(probe, dtype, bn):
    (xj, wj, _), (xt, wt, _) = _inputs(dtype, 0)
    want = probe.pallas_mv(xj, wj, bn)
    got = TM.matvec_plain(xt, wt)
    assert got.shape == (1, N) and got.dtype == xt.dtype and want.dtype == xj.dtype
    _close(got, want.astype(jnp.float32), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bm", [128, 1024])
def test_matvec_kt_plain_matches_pallas_mv_kt(probe, dtype, bm):
    """In bf16 the probe's program rounds each product to bf16, but XLA on
    the CPU compiles the interpreted kernel with excess precision and keeps
    the products in float32.  So the bf16 case is held to the bound of that
    difference: half a bf16 ulp of every product, 2^-9 sum_k |w x|, plus one
    bf16 ulp of the output, 2^-7 |out|."""
    (xj, _, wtj), (xt, _, wtt) = _inputs(dtype, 1)
    want = probe.pallas_mv_kt(xj, wtj, bm)
    got = TM.matvec_kt_plain(xt, wtt)
    assert got.shape == (N, 1) and got.dtype == torch.float32 and want.dtype == jnp.float32
    if dtype == "float32":
        _close(got, want, dtype)
        return
    want = np.asarray(want)
    bound = (2.0 ** -9 * (wtt.float().abs() * xt.float().abs()).sum(1, keepdim=True).numpy()
             + 2.0 ** -7 * np.abs(want))
    assert (np.abs(got.numpy() - want) <= bound).all()


def test_matvec_kt_rounds_like_the_pallas_body():
    """In bf16 each product is rounded to bf16 and the float32 sum is rounded
    to bf16: the result differs from the unrounded contraction wt @ x."""
    (_, _, _), (xt, _, wtt) = _inputs("bfloat16", 2)
    got = TM.matvec_kt_plain(xt, wtt)
    exact = wtt.float() @ xt.float().T
    assert torch.equal(got, got.bfloat16().float())
    assert not torch.equal(got, exact)


def test_wrappers_route_cpu_tensors_to_plain():
    (_, _, _), (xt, wt, wtt) = _inputs("float32", 3)
    before = (TM.matvec.launches, TM.matvec_kt.launches)
    assert torch.equal(TM.matvec(xt, wt), TM.matvec_plain(xt, wt))
    assert torch.equal(TM.matvec_kt(xt, wtt), TM.matvec_kt_plain(xt, wtt))
    assert (TM.matvec.launches, TM.matvec_kt.launches) == before  # kernel launches only


@pytest.mark.parametrize("bad", ["x_rows", "x_rank", "k_mismatch", "kt_k_mismatch"])
def test_wrappers_reject_bad_inputs(bad):
    (_, _, _), (xt, wt, wtt) = _inputs("float32", 4)
    with pytest.raises(ValueError):
        if bad == "x_rows":
            TM.matvec(torch.cat([xt, xt]), wt)
        elif bad == "x_rank":
            TM.matvec_kt(xt[0], wtt)
        elif bad == "k_mismatch":
            TM.matvec(xt, wt[1:])
        else:
            TM.matvec_kt(xt, wtt[:, 1:])


def test_matvec_splits_fill_one_wave():
    """K splits per column tile: a power of 2 up to 16, at least 64 rows
    each, the grid within two CTAs per SM: 16 at the qkv shape, 1 at the
    probe's default."""
    assert TM.matvec_splits(1024, 4096, torch.bfloat16, 132) == 16
    assert TM.matvec_splits(1024, 65536, torch.bfloat16, 132) == 1
    for K, N in [(1, 8), (1000, 4104), (8192, 8), (8192, 65536), (64, 4096), (1024, 8192)]:
        for dt in (torch.bfloat16, torch.float32):
            sp = TM.matvec_splits(K, N, dt, 132)
            tiles = -(-N // TM.matvec_tile(dt))
            assert sp & (sp - 1) == 0 and 1 <= sp <= TM.MAX_SPLITS
            assert sp == 1 or (K // sp >= TM.MIN_SPLIT_ROWS and tiles * sp <= 2 * 132)
