"""The port's baselines (``repro_torch.sparse``) against the reference's
(``repro.sparse``) on the CPU: every format x every small-suite matrix
packs bit-identical arrays under the same keys with the same byte and
padding counts, and its output agrees with the reference's and with the
float64 oracle within ``2e-4 * max|oracle| + 1e-5`` (the reference's own
tolerance in tests/test_baselines.py). The Perfect Format Selector times
the same candidates, picks one of them, and refuses a wrong format."""
import numpy as np
import pytest
import torch

from repro.core.matrices import make_suite as ref_make_suite
from repro.sparse.baselines import BASELINES as REF_BASELINES
from repro.sparse.baselines import build_baseline as ref_build
from repro_torch.core.matrices import make_suite
from repro_torch.sparse import (BASELINES, BaselineFormat,
                                PerfectFormatSelector, build_baseline)
from repro_torch.sparse import baselines as port_baselines

CPU = torch.device("cpu")
SUITE = make_suite("small")
REF_SUITE = ref_make_suite("small")


def _x(m):
    return np.random.default_rng(1).standard_normal(m.n_cols).astype(
        np.float32)


def test_same_formats_and_suite():
    assert list(BASELINES) == list(REF_BASELINES)
    for name, m in SUITE.items():
        r = REF_SUITE[name]
        assert (m.n_rows, m.n_cols) == (r.n_rows, r.n_cols)
        for a in ("rows", "cols", "vals"):
            np.testing.assert_array_equal(getattr(m, a), getattr(r, a))


@pytest.mark.parametrize("fmt", list(BASELINES))
@pytest.mark.parametrize("mname", list(SUITE))
def test_baseline_matches_reference(fmt, mname):
    m = SUITE[mname]
    port = build_baseline(fmt, m, device=CPU)
    ref = ref_build(fmt, REF_SUITE[mname])
    assert port.name == ref.name
    assert sorted(port.fmt) == sorted(ref.fmt)
    for k, t in port.fmt.items():
        a = np.asarray(ref.fmt[k])
        b = t.numpy()
        assert b.dtype == a.dtype and b.shape == a.shape, k
        assert b.tobytes() == a.tobytes(), f"{fmt} {mname}: {k} differs"
    assert port.stored_bytes == ref.stored_bytes
    assert port.padded_nnz == ref.padded_nnz
    x = _x(m)
    y = port(x)
    assert y.dtype == torch.float32 and y.device == CPU
    y = y.numpy()
    oracle = m.spmv_dense_oracle(x)
    atol = 2e-4 * (np.abs(oracle).max() + 1e-30) + 1e-5
    np.testing.assert_allclose(y, oracle, atol=atol, rtol=0)
    np.testing.assert_allclose(y, np.asarray(ref(x)), atol=atol, rtol=0)


def test_padding_accounting():
    m = SUITE["powerlaw_hard"]
    ell = build_baseline("ELL", m, device=CPU)
    merge = build_baseline("Merge", m, device=CPU)
    assert ell.padded_nnz >= m.nnz
    assert merge.padded_nnz >= m.nnz
    # ELL on scale-free data pads catastrophically; merge barely pads
    assert ell.padded_nnz > 5 * merge.padded_nnz


def test_pfs_times_every_candidate_and_picks_one():
    m = SUITE["powerlaw_mid"]
    cands = ["CSR", "ELL", "SELL", "CSR-Adaptive"]
    res = PerfectFormatSelector(candidates=cands, timing_repeats=2,
                                device=CPU).select(m)
    assert list(res.all_seconds) == cands
    assert res.best_name in cands
    assert res.best_seconds == min(res.all_seconds.values())
    assert res.best_format.name == res.best_name
    assert all(t > 0 for t in res.all_seconds.values())
    assert set(res.gflops_table) == set(cands)


def test_pfs_refuses_a_wrong_format(monkeypatch):
    def corrupted_csr(m, *, device=None):
        f = port_baselines.build_csr(m, device=device)
        fmt = dict(f.fmt, vals=f.fmt["vals"] * 1.5)
        return BaselineFormat(f.name, fmt, f.fn, f.stored_bytes,
                              f.padded_nnz)

    monkeypatch.setitem(port_baselines.BASELINES, "CSR", corrupted_csr)
    m = SUITE["banded"]
    with pytest.raises(AssertionError, match="baseline CSR produced wrong"):
        PerfectFormatSelector(candidates=["COO", "CSR"],
                              device=CPU).select(m)
    # without the oracle check the corrupted format is only timed
    res = PerfectFormatSelector(candidates=["CSR"], device=CPU).select(
        m, check_oracle=False)
    assert res.best_name == "CSR"


def test_baselines_default_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        build_baseline("CSR", SUITE["banded"])
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        PerfectFormatSelector()
