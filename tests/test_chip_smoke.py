"""chip_smoke.py phases at tiny sizes on the CPU, plus the installation
contract they rely on: no pandas on the main path, the compile-cache
location, CSV byte compatibility, and f32-exact filter contractions."""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from desman_tpu import io, synth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_main_refuses_without_gpu(capsys):
    assert chip_smoke.main([]) != 0
    captured = capsys.readouterr()
    assert "needs a GPU" in captured.err and "'cpu'" in captured.err
    assert '"ok"' not in captured.out


def test_phase_a_tiny(tmp_path):
    res = chip_smoke.phase_a(str(tmp_path), V=120, S=8, G_true=2,
                             g_values=(1, 2, 3), seeds=(0, 1),
                             iterations=40, max_snp_error=0.05,
                             max_gamma_mae=0.05)
    assert res["selected_G"] == 2
    assert res["warm_sweeps_per_s"] > 0 and len(res["first_run_s"]) == 3
    assert os.path.isfile(tmp_path / "best.txt")


def test_phase_b_tiny_interpreted():
    res = chip_smoke.phase_b(48, 6, 3, sweeps=6, chain_sweeps=6, reps=2,
                             interpret=True)
    assert res["sweep_draw_agreement"] >= 0.999
    assert set(res["sweeps_per_s"]) == {"xla", "pallas"}


def test_phase_c_tiny_on_four_cpu_devices(tmp_path):
    res = chip_smoke.phase_c(str(tmp_path), V=100, S=6, G=3, iterations=10,
                             kernels=("xla",))
    assert res["xla"]["tau_star_agreement"] >= 0.99


def test_phase_gate_failure_raises(tmp_path):
    """A missed gate is an error, not a printed warning."""
    with pytest.raises(chip_smoke.GateError):
        chip_smoke.phase_a(str(tmp_path), V=60, S=6, G_true=2,
                           g_values=(1,), seeds=(0,), iterations=10)


@pytest.mark.gpu
def test_phase_a_on_gpu(gpu, tmp_path):
    chip_smoke.phase_a(str(tmp_path), seeds=(0,))


@pytest.mark.gpu
def test_phase_c_on_gpu(gpu, tmp_path):
    if len(jax.devices()) < 4:
        pytest.skip("phase C needs four GPUs")
    chip_smoke.phase_c(str(tmp_path), iterations=20)


def test_main_path_without_pandas(tmp_path):
    """filter -> desman -> resolvenhap -> validate and every CSV reader and
    writer they use, in a process where importing pandas fails."""
    t = synth.generate(V=40, S=4, G=2, coverage=40.0, seed=2)
    counts = str(tmp_path / "c.csv")
    io.write_counts_csv(counts, t.data)
    truth = str(tmp_path / "truth.csv")
    io.write_tau_star_csv(truth, t.tau_idx, t.data.contigs, t.data.positions)
    code = f"""
import sys
sys.modules["pandas"] = None
import jax
jax.config.update("jax_platforms", "cpu")
from desman_tpu import cli, io
d = {str(tmp_path)!r}
assert cli.main(["filter", {counts!r}, "-o", d + "/f_", "-q", "1.0"]) == 0
assert cli.main(["desman", {counts!r}, "-g", "2", "-i", "8", "-o",
                 d + "/run_2_0", "-e", d + "/f_tran_df.csv"]) == 0
assert cli.main(["resolvenhap", d + "/run_*", "-o", d + "/best.txt"]) == 0
assert cli.main(["validate", "-p", d + "/run_2_0/Filtered_Tau_star.csv",
                 "-t", {truth!r}]) == 0
data = io.read_counts_csv({counts!r}, prefer_native=False)
io.write_counts_csv(d + "/back.csv", data)
io.read_gamma_csv(d + "/run_2_0/Gamma_mean.csv")
io.read_tau_mean_csv(d + "/run_2_0/Tau_mean.csv")
assert "pandas" not in [m for m in sys.modules if sys.modules[m] is not None]
print("NO_PANDAS_OK")
"""
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "DESMAN_TPU_NO_CACHE": "1"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "NO_PANDAS_OK" in r.stdout
    assert open(tmp_path / "back.csv").read() == open(counts).read()


@pytest.mark.parametrize("writer", ["counts", "eta", "gamma", "tau_star",
                                    "tau_mean", "p_df", "records"])
def test_csv_writers_byte_compatible_with_pandas(writer, tmp_path):
    """The csv/numpy writers produce the bytes the pandas writers did."""
    pd = pytest.importorskip("pandas")
    from desman_tpu.utils import BASES

    rng = np.random.default_rng(0)
    V, S, G = 7, 3, 2
    contigs = np.array(["c1", "c,2", "c3", "c1", "x", "y", "z"])
    pos = np.arange(V) * 10
    ours, theirs = str(tmp_path / "a.csv"), str(tmp_path / "b.csv")
    if writer == "counts":
        data = io.CountsData(rng.integers(0, 50, (V, S, 4)).astype(np.int32),
                             contigs, pos, [f"s{i}" for i in range(S)])
        io.write_counts_csv(ours, data)
        out = {"Contig": contigs, "Position": pos}
        for s, name in enumerate(data.samples):
            for a, b in enumerate(BASES):
                out[f"{name}-{b}"] = data.counts[:, s, a]
        pd.DataFrame(out).to_csv(theirs, index=False)
    elif writer == "eta":
        eta = synth.make_eta(0.013)
        io.write_eta_csv(ours, eta)
        pd.DataFrame(eta, index=list(BASES),
                     columns=list(BASES)).to_csv(theirs)
    elif writer == "gamma":
        gamma = rng.dirichlet(np.ones(G), size=S).astype(np.float32)
        io.write_gamma_csv(ours, gamma, ["a", "b", "c"])
        pd.DataFrame(gamma, index=["a", "b", "c"],
                     columns=["H1", "H2"]).to_csv(theirs)
    elif writer == "tau_star":
        tau = rng.integers(0, 4, (V, G))
        io.write_tau_star_csv(ours, tau, contigs, pos)
        out = {"Contig": contigs, "Position": pos}
        for g in range(G):
            oh = np.eye(4, dtype=np.int64)[tau[:, g]]
            for a, b in enumerate(BASES):
                out[f"H{g + 1}-{b}"] = oh[:, a]
        pd.DataFrame(out).to_csv(theirs, index=False)
    elif writer == "tau_mean":
        tm = rng.dirichlet(np.ones(4), size=(V, G)).astype(np.float32)
        io.write_tau_mean_csv(ours, tm, contigs, pos)
        out = {"Contig": contigs, "Position": pos}
        for g in range(G):
            for a, b in enumerate(BASES):
                out[f"H{g + 1}-{b}"] = tm[:, g, a]
        pd.DataFrame(out).to_csv(theirs, index=False)
    elif writer == "p_df":
        p = np.array([1.0, 0.5, 1e-300, 3.2e-7, 0.123456789, 1.0, 0.0])
        io.write_position_csv(ours, contigs, pos, "p", p)
        pd.DataFrame({"Contig": contigs, "Position": pos,
                      "p": p}).to_csv(theirs, index=False)
    else:
        recs = [{"G": 1, "seed": 0, "mean_deviance": 123.456,
                 "uncertainty": 0.1, "run_dir": "out/run_1_0"},
                {"G": 2, "seed": 3, "mean_deviance": 1e-5,
                 "uncertainty": 0.0, "run_dir": None}]
        io.write_records_csv(ours, recs)
        pd.DataFrame(recs).to_csv(theirs, index=False)
    assert open(ours, "rb").read() == open(theirs, "rb").read()


def test_compilation_cache_follows_env_var(tmp_path, monkeypatch):
    from desman_tpu import utils

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cc"))
    monkeypatch.delenv("DESMAN_TPU_NO_CACHE")
    before = jax.config.jax_compilation_cache_dir
    try:
        assert utils.compilation_cache_dir() == str(tmp_path / "cc")
        utils.enable_compilation_cache()
        assert jax.config.jax_compilation_cache_dir == str(tmp_path / "cc")
        assert os.path.isdir(tmp_path / "cc")
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compilation_cache_default_is_fixed_in_checkout(monkeypatch):
    from desman_tpu import utils

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(REPO, ".jax_cache")
    assert utils.compilation_cache_dir() == want
    # independent of the working directory and of HOME
    monkeypatch.chdir("/")
    monkeypatch.setenv("HOME", "/nonexistent")
    assert utils.compilation_cache_dir() == want


def test_filter_contractions_match_float64():
    """_h0_loglik and _reestimate_eta (heinsum, HIGHEST precision) against
    float64 numpy: no reduced-precision contraction on any backend."""
    from desman_tpu.filter import _h0_loglik, _reestimate_eta

    t = synth.generate(V=300, S=8, G=3, coverage=80.0, seed=4)
    c = t.data.counts.sum(axis=1).astype(np.float64)          # [V,4]
    eta = synth.make_eta(0.01)
    ll, base = _h0_loglik(jnp.asarray(c, jnp.float32),
                          jnp.asarray(eta, jnp.float32))
    want = c @ np.log(eta).T
    np.testing.assert_allclose(np.asarray(ll), want.max(axis=1), rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(base), want.argmax(axis=1))

    consistent = np.random.default_rng(0).random(300) < 0.7
    got = _reestimate_eta(jnp.asarray(c, jnp.float32), jnp.asarray(base),
                          jnp.asarray(consistent))
    rows = np.eye(4)[want.argmax(axis=1)].T @ (consistent[:, None] * c)
    rows += np.eye(4)
    np.testing.assert_allclose(np.asarray(got),
                               rows / rows.sum(axis=1, keepdims=True),
                               rtol=1e-6)


def test_make_mesh_uses_first_devices():
    from desman_tpu.parallel import make_mesh

    mesh = make_mesh(n_chain=1, n_data=4)
    assert mesh.devices.shape == (1, 4)
    assert list(mesh.devices.ravel()) == jax.devices()[:4]
    with pytest.raises(ValueError, match="devices"):
        make_mesh(n_chain=3, n_data=3)


def test_smoke_last_line_contract(monkeypatch, capsys, tmp_path):
    """With the platform check and the phases stubbed, main() prints the
    card lines first and ends with exactly the device JSON."""
    class Dev:
        platform, device_kind = "gpu", "NVIDIA H100 80GB HBM3"

    monkeypatch.setattr(jax, "devices", lambda *a: [Dev()])
    monkeypatch.setattr(chip_smoke, "card_lines",
                        lambda: ["NVIDIA H100 80GB HBM3, 700.00 W"])
    monkeypatch.setattr(chip_smoke, "OUT", str(tmp_path))
    monkeypatch.setattr(chip_smoke, "phase_a", lambda *a, **k: {})
    monkeypatch.setattr(chip_smoke, "phase_b", lambda *a, **k: {})
    assert chip_smoke.main([]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "card: NVIDIA H100 80GB HBM3, 700.00 W"
    assert json.loads(lines[-1]) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
