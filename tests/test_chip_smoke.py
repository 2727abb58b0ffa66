"""chip_smoke.py without a card: it must refuse to run on the CPU, and its
phases (run here at small widths) must pass on the CPU backend so a card
run only has the card to find out about."""
import json
import os
import subprocess
import sys

import jax
import pytest

import chip_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_require_gpus_refuses_cpu():
    with pytest.raises(RuntimeError, match="GPU"):
        chip_smoke.require_gpus(1)


@pytest.mark.parametrize("argv", [[], ["--four-cards"]])
def test_main_refuses_cpu_only_run(argv):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "chip_smoke.py"] + argv,
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 2
    for line in out.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)


def test_dot_precisions_parser():
    import jax.numpy as jnp
    f = jax.jit(lambda a, b: (
        jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST),
        jnp.matmul(a, b)))
    text = f.lower(jnp.ones((4, 4)), jnp.ones((4, 4))).as_text()
    assert sorted(chip_smoke.dot_precisions(text)) == ["DEFAULT", "HIGHEST"]


def test_ds_parity_phase_small():
    chip_smoke.phase_ds_parity(n_c=200, chunk_samps=3 * 20000, n_tpl=150,
                               net_rows=6, net_prefer_os=True)


def test_four_cards_phase_on_virtual_mesh(tmp_path, monkeypatch):
    """The --four-cards phase on the CPU's virtual devices (conftest: 8),
    at 20 Hz over 8 h."""
    monkeypatch.setenv("DETEX_TPU_TRIM_QUANTUM", "64")
    monkeypatch.chdir(tmp_path)
    chip_smoke.phase_four_cards(str(tmp_path), n_cards=len(jax.devices()),
                                hours=8, sr=20.0)
