"""The PyTorch port's restart files and solo CLI against the JAX package
(float64, CPU, C12L10): checkpoints the port writes (.npz and .fvio) load
in the JAX package's load_state with its manifest checksums, checkpoints
the JAX package writes resume in the port (and step as the port's own run
does, bit for bit), a run of N+M steps equals N steps, a restart and M
steps bit for bit, and main() runs a step on the CPU, audits, writes a
restart and reads it back; on the way the timers, the audits, the
fv_core.res export and the startup helpers."""

import json
import struct

import numpy as np
import pytest
import torch

from gfdl_atmos_cubed_sphere_tpu.driver.solo import Atmosphere as JAtm
from gfdl_atmos_cubed_sphere_tpu.io import restart as jrst
from gfdl_atmos_cubed_sphere_tpu_torch.driver.solo import Atmosphere, main
from gfdl_atmos_cubed_sphere_tpu_torch.io import diagnostics, native_io
from gfdl_atmos_cubed_sphere_tpu_torch.io import restart as rst
from gfdl_atmos_cubed_sphere_tpu_torch.utils.timing import Timers, device_trace
from test_torch_solo import one_core

pytestmark = pytest.mark.fast

NPX, K, DT = 13, 10, 600.0
FIELDS = ("delp", "pt", "u", "v", "w", "delz", "phis")


def _write_port_restarts(tmp_path):
    atm = Atmosphere(NPX, K, DT, physics="hs", dtype="f64", device="cpu",
                     cfg_overrides=dict(consv_te=1.0, consv_am=True))
    atm.atmosphere(2)
    paths = [str(tmp_path / "port.npz"), str(tmp_path / "port.fvio")]
    for p in paths:
        atm.write_restart(p)
    return atm, paths


def test_restart_interchange_resume_and_cli(tmp_path, capsys, monkeypatch):
    with one_core():
        _restart_interchange_resume_and_cli(tmp_path, capsys, monkeypatch)


def _restart_interchange_resume_and_cli(tmp_path, capsys, monkeypatch):
    fix = dict(consv_te=1.0, consv_am=True)
    atm, paths = _write_port_restarts(tmp_path)

    # the port's checkpoints load in the JAX package, with its checksums,
    # and equal the JAX package's own checkpoint of the same state
    jpath = str(tmp_path / "jax_of_port.npz")
    jrst.save_state(jpath, {k: v.numpy() for k, v in atm.state.items()},
                    ak=atm.ak, bk=atm.bk, step=atm.step_count,
                    time_seconds=atm.time_seconds)
    want = jrst.load_state(jpath)[2]
    for p in paths:
        state, tracers, manifest = jrst.load_state(p)
        assert manifest == want and tracers == {}
        for k in FIELDS:
            assert np.array_equal(state[k], atm.state[k].numpy()), (p, k)
            assert manifest["checksums"][k] == jrst._checksum(state[k])

    # N + M continuous steps equal N steps, a restart and M steps
    atm.atmosphere(2)
    for p in paths:
        back = Atmosphere(NPX, K, DT, physics="hs", dtype="f64",
                          device="cpu", restart=p, cfg_overrides=fix)
        assert (back.step_count, back.time_seconds) == (2, 2 * DT)
        back.atmosphere(2)
        for k in FIELDS:
            assert torch.equal(back.state[k], atm.state[k]), (p, k)

    # the JAX package's checkpoints (of its initial state) resume in the
    # port, and the run from them equals the port's own run bit for bit
    ja = JAtm(NPX, K, DT, physics="hs", dtype="f64", cfg_overrides=fix)
    own = Atmosphere(NPX, K, DT, physics="hs", dtype="f64", device="cpu",
                     cfg_overrides=fix)
    own.atmosphere(1)
    for name in ("jax.npz", "jax.fvio"):
        p = str(tmp_path / name)
        ja.write_restart(p)
        back = Atmosphere(NPX, K, DT, physics="hs", dtype="f64",
                          device="cpu", restart=p, cfg_overrides=fix)
        assert back.step_count == 0
        for k in FIELDS:
            assert np.array_equal(back.state[k].numpy(),
                                  np.asarray(ja.state[k])), (p, k)
        back.atmosphere(1)
        for k in FIELDS:
            assert torch.equal(back.state[k], own.state[k]), (p, k)

    # a damaged checkpoint fails its checksum
    z = dict(np.load(paths[0]))
    z["pt"] = z["pt"] + 1.0
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, **z)
    with pytest.raises(ValueError, match="checksum"):
        rst.load_state(bad)
    # a damaged .fvio record fails its CRC (one bit of the first payload)
    data = bytearray(open(paths[1], "rb").read())
    nl = struct.unpack_from("<I", data, 8)[0]
    ndim = data[8 + 4 + nl + 1]
    data[8 + 4 + nl + 2 + 8 * ndim + 8] ^= 1
    bad = str(tmp_path / "bad.fvio")
    open(bad, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        native_io.read_fvio(bad)

    # the CLI on the CPU: one step, an audit, a restart written and read
    out = str(tmp_path / "cli.fvio")
    argv = ["--npx", str(NPX), "--npz", str(K), "--dt", "1200",
            "--physics", "hs", "--days", str(1200.0 / 86400.0),
            "--audit-every", "1", "--device", "cpu"]
    main(argv + ["--restart-out", out])
    main(argv + ["--restart-in", out])
    text = capsys.readouterr().out
    assert "running 1 steps" in text and "restart written" in text
    assert "step 1 " in text and "step 2 " in text and "FV_DYNAMICS" in text
    assert native_io.native_available()
    assert rst.load_state(out)[2]["step"] == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            main(argv[:-2])
    # a library that does not build: the writer raises with g++'s reason
    broken = tmp_path / "broken.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native_io, "_lib", None)
    monkeypatch.setattr(native_io, "SOURCE", broken)
    monkeypatch.setattr(native_io, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on .*broken.cpp"):
        native_io.AsyncWriter(str(tmp_path / "never.fvio"))

    # audits and timers
    lines = []
    lo, hi = diagnostics.prt_maxmin("T", atm.state["pt"], out=lines.append)
    assert lo == float(atm.state["pt"].min()) and len(lines) == 1
    assert diagnostics.nan_check({"a": torch.tensor([1.0, np.nan]),
                                  "b": torch.ones(2), "c": None}) == ["a"]
    assert diagnostics.range_check("pt", atm.state["pt"])[0]
    assert not diagnostics.range_check("u", torch.tensor([0.0, 300.0]))[0]
    t = Timers(device="cpu")
    with t("A"):
        with t("B"):
            pass
    assert sorted(t.asdict()) == ["A", "A/B"]
    assert t.asdict()["A"]["calls"] == 1
    with device_trace(str(tmp_path / "trace")):
        torch.ones(3).sum()
    assert json.load(open(tmp_path / "trace" / "trace.json"))

    # fv_core.res export, read back by both packages; startup helpers
    nc = str(tmp_path / "fv_core.res.nc")
    rst.export_fv_core_res(nc, atm.state, atm.ak, atm.bk,
                           tracers={"sphum": atm.state["pt"] * 0.0})
    for reader in (rst.import_fv_core_res, jrst.import_fv_core_res):
        state, ak, bk, tracers = reader(nc)
        assert np.array_equal(ak, atm.ak) and list(tracers) == ["sphum"]
        for k in ("u", "v", "pt", "delp", "w", "delz", "phis"):
            want = atm.state[k].numpy().reshape(state[k].shape)
            assert np.array_equal(state[k], want), k
    sphum = 0.01 * torch.rand(atm.state["pt"].shape, dtype=torch.float64,
                              generator=torch.Generator().manual_seed(2))
    for q in (None, sphum):
        w, delz = rst.make_nh_state(atm.state["pt"], atm.state["delp"],
                                    atm.ptop, sphum=q)
        _, jdelz = jrst.make_nh_state(
            atm.state["pt"].numpy(), atm.state["delp"].numpy(), atm.ptop,
            sphum=None if q is None else q.numpy())
        assert not w.any()
        assert np.abs(delz.numpy() - np.asarray(jdelz)).max() <= (
            1e-12 * np.abs(np.asarray(jdelz)).max())
    pt2, rms = rst.add_thermal_noise(atm.state["pt"], 0.5, seed=1)
    d = (pt2 - atm.state["pt"]).numpy()
    assert 0.0 <= d.min() and d.max() < 0.5 and 0.1 < rms < 0.5
    # remap_restart onto the state's own coordinate gives the state back,
    # as the JAX package's tests/test_remap_restart.py asserts of its own
    out, _ = rst.remap_restart(atm.state, None, atm.ak, atm.bk, atm.ak,
                               atm.bk, atm.g, hydrostatic=False)
    for k in ("delp", "pt", "u", "v", "w", "delz"):
        np.testing.assert_allclose(out[k].numpy(), atm.state[k].numpy(),
                                   rtol=5e-13, atol=1e-10, err_msg=k)
