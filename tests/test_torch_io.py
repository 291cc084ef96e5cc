"""Field I/O and checkpoints (io.py, models/simulate.save_state), port vs JAX.

The port builds its own copy of the C++ serializer (native/gmg_io.cpp) into
its `_build/`; a file it writes is the same bytes as the JAX package's for
every dtype, each package loads the other's files and checkpoints, and a
checkpointed run resumed from disk reproduces the straight run (the liquid
SDF within 1e-12, velocity within 1e-9, as the JAX package's own resume test
holds it: the round trip is exact, the rest is solver rounding).
"""

import io
import json
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

from geometricmultigridpressuresolver_tpu import io as jax_io
from geometricmultigridpressuresolver_tpu.models import sdf as jax_sdf
from geometricmultigridpressuresolver_tpu.models import simulate as jax_sim
from geometricmultigridpressuresolver_tpu_torch import io as gio
from geometricmultigridpressuresolver_tpu_torch.config import SolverConfig
from geometricmultigridpressuresolver_tpu_torch.models import simulate

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
DTYPES = (np.float32, np.float64, np.int8, np.int32)


def _field(dtype, shape=(33, 17, 26), seed=0):
    """Random values with constant tiles mixed in (both tile kinds)."""
    rng = np.random.default_rng(seed)
    arr = (rng.standard_normal(shape) * 50).astype(dtype)
    arr[:16, :16, :] = 3
    return arr


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_field_files_byte_identical_and_interchangeable(tmp_path, dtype):
    arr = _field(dtype)
    mine, theirs = tmp_path / "port.gmgf", tmp_path / "jax.gmgf"
    gio.save_field(mine, arr)
    jax_io.save_field(theirs, arr)
    assert mine.read_bytes() == theirs.read_bytes()
    for load, path in ((gio.load_field, theirs), (jax_io.load_field, mine), (gio.load_field, mine)):
        out = load(path)
        assert out.dtype == arr.dtype and out.shape == arr.shape
        np.testing.assert_array_equal(out, arr)
    assert gio.field_info(mine) == ((33, 17, 26), np.dtype(dtype), 16)


def test_tensor_fields_and_constant_tile_compression(tmp_path):
    arr = np.zeros((64, 64, 64), dtype=np.float32)
    arr[16:32, 16:32, 16:32] = np.random.default_rng(1).standard_normal((16, 16, 16))
    path = tmp_path / "c.gmgf"
    gio.save_field(path, torch.from_numpy(arr))  # a tensor goes to the host first
    assert path.stat().st_size < arr.nbytes / 10
    np.testing.assert_array_equal(gio.load_field(path), arr)


def test_scene_roundtrip_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    fields = {
        "liquid_phi": rng.standard_normal((24, 24, 24)).astype(np.float32),
        "vel_x": rng.standard_normal((25, 24, 24)).astype(np.float32),
        "labels": rng.integers(0, 4, (24, 24, 24)).astype(np.int8),
    }
    gio.save_scene(tmp_path / "port", **fields)
    jax_io.save_scene(tmp_path / "jax", **fields)
    for name in ("manifest.json", *(f"{k}.gmgf" for k in fields)):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    for out in (gio.load_scene(tmp_path / "jax"), jax_io.load_scene(tmp_path / "port")):
        assert set(out) == set(fields)
        for k in fields:
            np.testing.assert_array_equal(out[k], fields[k])


def test_bad_files_raise(tmp_path):
    bad = tmp_path / "bad.gmgf"
    bad.write_bytes(b"NOPE" + b"\0" * 64)
    with pytest.raises(IOError, match="bad magic"):
        gio.load_field(bad)
    with pytest.raises(IOError, match="cannot open"):
        gio.load_field(tmp_path / "missing.gmgf")
    good = tmp_path / "good.gmgf"
    gio.save_field(good, _field(np.float64))
    truncated = tmp_path / "truncated.gmgf"
    truncated.write_bytes(good.read_bytes()[:200])
    with pytest.raises(IOError, match="truncated"):
        gio.load_field(truncated)
    with pytest.raises(ValueError, match="3-D"):
        gio.save_field(tmp_path / "x.gmgf", np.zeros((4, 4)))
    with pytest.raises(ValueError, match="unsupported dtype"):
        gio.save_field(tmp_path / "x.gmgf", np.zeros((4, 4, 4), dtype=np.int16))


def test_library_is_the_ports_own_build():
    """Built from the port's source into its gitignored _build/, never the
    JAX package's libgmg_io.so; the source is the JAX package's unchanged."""
    path = gio.library_path()
    assert path.parent == gio.BUILD_DIR and path.name.startswith("libgmg_io_")
    assert "geometricmultigridpressuresolver_tpu_torch/_build/" in (REPO / ".gitignore").read_text().split()
    jax_source = REPO / "geometricmultigridpressuresolver_tpu" / "native" / "gmg_io.cpp"
    assert gio.SOURCE.read_bytes() == jax_source.read_bytes()
    gio._library()
    assert path.exists()


def _splash(n):
    phi, velocity = jax_sdf.splash_scene((n, n, n))
    return phi, velocity, jax_sdf.open_box_weights((n, n, n))


def test_checkpoints_interchange_with_jax(tmp_path):
    rng = np.random.default_rng(3)
    phi = rng.standard_normal((12, 12, 12))
    velocity = tuple(rng.standard_normal(s) for s in ((13, 12, 12), (12, 13, 12), (12, 12, 13)))
    pressure = rng.standard_normal((12, 12, 12))
    simulate.save_state(tmp_path / "port", 5, torch.from_numpy(phi),
                        tuple(map(torch.from_numpy, velocity)), torch.from_numpy(pressure))
    jax_sim.save_state(tmp_path / "jax", 5, phi, velocity, pressure)
    for path in sorted((tmp_path / "jax").iterdir()):
        assert (tmp_path / "port" / path.name).read_bytes() == path.read_bytes(), path.name
    for load, where in ((simulate.load_state, "jax"), (jax_sim.load_state, "port")):
        frame, phi2, vel2, p2 = load(tmp_path / where)
        assert frame == 5 and all(isinstance(a, np.ndarray) for a in (phi2, *vel2, p2))
        np.testing.assert_array_equal(phi2, phi)
        np.testing.assert_array_equal(p2, pressure)
        for a in range(3):
            np.testing.assert_array_equal(vel2[a], velocity[a])
    simulate.save_state(tmp_path / "no_p", 1, phi, velocity)
    assert simulate.load_state(tmp_path / "no_p")[3] is None


def test_checkpoint_resume_matches_straight_run(tmp_path):
    n = 24
    config = SolverConfig(tolerance=1e-8, max_iterations=300)
    phi, velocity, weights = _splash(n)
    kw = dict(dt=1.0 / 60.0, config=config, device="cpu")
    straight = simulate.run(phi, velocity, weights, num_frames=3, **kw)
    ckpt = tmp_path / "ckpt"
    simulate.run(phi, velocity, weights, num_frames=2, checkpoint_dir=ckpt, checkpoint_every=2, **kw)
    frame, phi2, vel2, pressure2 = simulate.load_state(ckpt)
    assert frame == 2 and pressure2 is not None
    np.testing.assert_array_equal(pressure2, straight[1].pressure.numpy())
    resumed = simulate.run(phi2, vel2, weights, num_frames=1, start_frame=frame,
                           old_pressure=pressure2, **kw)
    assert resumed[0].iterations == straight[2].iterations
    np.testing.assert_allclose(resumed[0].liquid_phi.numpy(), straight[2].liquid_phi.numpy(),
                               rtol=0, atol=1e-12)
    for a in range(3):
        np.testing.assert_allclose(resumed[0].velocity[a].numpy(), straight[2].velocity[a].numpy(),
                                   rtol=0, atol=1e-9)


def test_cli_writes_a_checkpoint_and_resumes(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    out = io.StringIO()
    with redirect_stdout(out):
        rc = simulate.main(["--n", "16", "--frames", "2", "--device", "cpu",
                            "--checkpoint-dir", ckpt, "--checkpoint-every", "2"])
    assert rc == 0
    assert json.loads((Path(ckpt) / "state.json").read_text()) == {"frame": 2, "format": 1}
    out = io.StringIO()
    with redirect_stdout(out):
        rc = simulate.main(["--n", "16", "--frames", "1", "--device", "cpu", "--resume", ckpt,
                            "--checkpoint-dir", ckpt, "--checkpoint-every", "1"])
    lines = out.getvalue().splitlines()
    assert rc == 0
    assert lines[0] == f"resumed frame 2 from {ckpt}" and lines[1].startswith("frame 3: iters=")
    assert json.loads((Path(ckpt) / "state.json").read_text())["frame"] == 3
