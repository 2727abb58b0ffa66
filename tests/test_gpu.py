"""Card-only checks (marker ``gpu``): the device scan against the float64
reference on an NVIDIA GPU, and the device-memory budget read from the
card. Run with ``python -m pytest tests/ -m gpu -p no:xdist`` on the card
(chip_smoke.py runs them); elsewhere the ``gpu`` fixture skips them."""
import numpy as np
import pytest

from detex_tpu.ops import ds as dsops
from detex_tpu.parallel import scan as pscan

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("prefer_os", [False, True])
def test_scan_matches_float64_on_gpu(gpu, prefer_os):
    rng = np.random.default_rng(0)
    nc, n_c = 3, 1000
    Lc = nc * 200_000
    U = np.linalg.qr(rng.standard_normal((n_c * nc, 4)))[0].T
    x = rng.standard_normal(Lc)
    bank = dsops.build_bank([U], nc, Lc, prefer_os=prefer_os, pad_S=8)
    assert bool(bank.get("os")) == prefer_os
    hist, maxds, *_ = pscan.scan_chunks(
        x[None].astype(np.float32), bank, np.full(8, np.inf, np.float32),
        nc, buff_samps=2000, max_trig=1, calc_triggers=False)
    dev = dsops.run_bank_batch([x.astype(np.float32)], bank, nc)[0][0]
    ref = dsops.ds_numpy(x, U, nc)
    assert np.abs(dev - ref).max() < 2e-5
    assert abs(float(maxds[0, 0]) - ref.max()) < 2e-5
    assert int(np.asarray(hist)[0].sum()) == len(ref)


def test_hbm_budget_reads_the_card(gpu):
    limit = gpu.memory_stats()["bytes_limit"]
    assert dsops.hbm_budget(gpu) == limit // 10 > (2 << 30)


def test_engine_mesh_spans_local_gpus(gpu):
    import jax
    mesh = pscan.engine_mesh()
    if len(jax.devices()) == 1:
        assert mesh is None
    else:
        assert mesh.size == len(jax.devices())
