"""The port's real-world loaders (``dqgp_tpu_torch/data/real_world.py``) and
``save_quantum_dataset`` against the JAX package's, seed for seed.

Bars: X identical; Y identical where no scaling runs, within 1e-12 where the
port's numpy StandardScaler stands in for sklearn's (the summation order of
its mean and variance); the scaler itself within 1e-15 of sklearn's; the
.hgt parser identical to the JAX package's (its native parser where built,
else its numpy fallback) on 1201^2 and 3601^2 tiles.
"""

import os

import numpy as np
import pytest

from dqgp_tpu.data import real_world as JR
from dqgp_tpu.data import synthetic as JS
from dqgp_tpu_torch.data import real_world as TR
from dqgp_tpu_torch.data import synthetic as TS
from scripts.make_synthetic_tiles import TILES, write_tile
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SCALED_TOL = 1e-12


def _same(got, want, scaled: bool):
    (Xg, Yg), (Xw, Yw) = got, want
    assert Xg.shape == Xw.shape and Yg.shape == Yw.shape
    if scaled:
        np.testing.assert_allclose(Xg, Xw, rtol=0, atol=SCALED_TOL)
        np.testing.assert_allclose(Yg, Yw, rtol=0, atol=SCALED_TOL)
    else:
        np.testing.assert_array_equal(Xg, Xw)
        np.testing.assert_array_equal(Yg, Yw)


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("kw", [
    dict(subsample_factor=10, max_samples=None, random_state=42),
    dict(subsample_factor=20, max_samples=150, random_state=1),
    dict(subsample_factor=5, max_samples=500, random_state=7),
])
def test_sst_matches_jax(kw, normalize):
    _same(TR.load_sea_surface_temperature(normalize=normalize, **kw),
          JR.load_sea_surface_temperature(normalize=normalize, **kw), normalize)


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("include_force", [False, True])
@pytest.mark.parametrize("max_samples,seed", [(None, 42), (300, 1)])
def test_robot_push_matches_jax(include_force, normalize, max_samples, seed):
    kw = dict(normalize=normalize, include_force=include_force, max_samples=max_samples,
              random_state=seed)
    _same(TR.load_robot_push_dataset(**kw), JR.load_robot_push_dataset(**kw), normalize)


@pytest.fixture(scope="module")
def tile_dir(tmp_path_factory):
    """The four stand-in tiles of scripts/make_synthetic_tiles.py."""
    d = str(tmp_path_factory.mktemp("srtm_data"))
    for tile in TILES:
        write_tile(tile, d)
    return d


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("region", sorted(TR.SRTM_REGIONS))
def test_srtm_regions_match_jax(region, normalize, tile_dir):
    kw = dict(region=region, max_samples=1000, subsample_factor=10, normalize=normalize,
              random_state=42, data_dir=tile_dir)
    got = TR.load_srtm_elevation_dataset(**kw)
    _same(got, JR.load_srtm_elevation_dataset(**kw), normalize)
    assert got[0].shape == (1000, 2)


def test_srtm_use_preprocessed_matches_jax(tmp_path):
    d = tmp_path / "pre"
    d.mkdir()
    rng = np.random.RandomState(3)
    np.save(d / "N43W080.npy", rng.uniform(50.0, 700.0, (401, 401)))
    kw = dict(region="great_lakes", max_samples=300, subsample_factor=2, normalize=True,
              random_state=5, use_preprocessed=True, preprocessed_dir=str(d))
    _same(TR.load_srtm_elevation_dataset(**kw), JR.load_srtm_elevation_dataset(**kw), True)
    np.save(d / "N45W123.npy", np.zeros((4, 5)))
    with pytest.raises(ValueError, match="preprocessed data shape"):
        TR.load_srtm_elevation_dataset(region="oregon_coast", use_preprocessed=True,
                                       preprocessed_dir=str(d))
    with pytest.raises(FileNotFoundError):
        TR.load_srtm_elevation_dataset(region="maharashtra", use_preprocessed=True,
                                       preprocessed_dir=str(d))


def test_srtm_errors_match_jax(tmp_path):
    with pytest.raises(ValueError, match="not supported"):
        TR.load_srtm_elevation_dataset(region="atlantis")
    with pytest.raises(FileNotFoundError, match="make_synthetic_tiles.py"):
        TR.load_srtm_elevation_dataset(region="maharashtra", data_dir=str(tmp_path))
    bad = tmp_path / "bad.hgt"
    bad.write_bytes(b"\0" * 100)
    with pytest.raises(ValueError, match="Unexpected HGT file size"):
        TR.read_hgt_file(str(bad))


@pytest.mark.parametrize("name,kw", [
    ("sst", dict(max_samples=200, subsample_factor=20, random_state=1)),
    ("Sea_Surface_Temperature", dict(max_samples=100, random_state=2)),
    ("robot", dict(max_samples=300, normalize=False, random_state=1)),
    ("push", dict(max_samples=50, include_force=True, random_state=1)),
    ("robot_push", dict(max_samples=80, random_state=3)),
])
def test_dispatch_aliases_match_jax(name, kw):
    _same(TR.load_real_world_dataset(name, **kw), JR.load_real_world_dataset(name, **kw),
          kw.get("normalize", True))


@pytest.mark.parametrize("name", ["srtm", "elevation", "srtm_elevation"])
def test_srtm_aliases_match_jax(name, tile_dir):
    kw = dict(region="washington_coast", max_samples=400, data_dir=tile_dir, random_state=9)
    _same(TR.load_real_world_dataset(name, **kw), JR.load_real_world_dataset(name, **kw), True)


def test_metadata_matches_jax():
    assert TR.get_dataset_info() == JR.get_dataset_info()
    assert TR.SRTM_REGIONS == JR.SRTM_REGIONS
    for region in list(TR.SRTM_REGIONS) + ["N00E000"]:
        assert TR.get_tile_for_region(region) == JR.get_tile_for_region(region)
    with pytest.raises(ValueError, match="Unknown real-world dataset"):
        TR.load_real_world_dataset("mars")


@pytest.mark.parametrize("shape,seed", [((50, 1), 0), ((300, 2), 1), ((1000, 3), 2),
                                        ((7, 4), 3)])
def test_standard_scale_matches_sklearn(shape, seed):
    from sklearn.preprocessing import StandardScaler

    rng = np.random.RandomState(seed)
    a = rng.normal(3.0, 50.0, shape) * rng.uniform(0.1, 10.0, shape[1])
    a[:, 0] = np.round(a[:, 0])
    np.testing.assert_allclose(TR.standard_scale(a), StandardScaler().fit_transform(a),
                               rtol=0, atol=1e-15)


def test_standard_scale_constant_column_matches_sklearn():
    from sklearn.preprocessing import StandardScaler

    a = np.column_stack([np.full(20, 4.5), np.arange(20.0)])
    np.testing.assert_array_equal(TR.standard_scale(a), StandardScaler().fit_transform(a))


def _fake_tile(path, n, seed):
    rng = np.random.RandomState(seed)
    data = rng.randint(-500, 3000, size=(n, n)).astype(">i2")
    data[0, :50] = -32768
    data.tofile(path)


@pytest.mark.parametrize("n", [1201, 3601])
def test_read_hgt_identical_to_jax(n, tmp_path):
    path = str(tmp_path / "N17E073.hgt")
    _fake_tile(path, n, seed=n)
    got = TR.read_hgt_file(path)
    assert got.dtype == np.float64 and got.shape == (n, n)
    np.testing.assert_array_equal(got, JR.read_hgt_file(path))


def test_read_hgt_stand_in_tiles_identical_to_jax(tile_dir):
    for tile in TILES:
        path = os.path.join(tile_dir, f"{tile}.hgt")
        np.testing.assert_array_equal(TR.read_hgt_file(path), JR.read_hgt_file(path))


@pytest.mark.parametrize("d,n", [(1, 20), (3, 7)])
def test_save_quantum_dataset_writes_the_jax_file(d, n, tmp_path):
    rng = np.random.RandomState(d)
    X, Y = rng.uniform(-2, 2, (n, d)), rng.normal(size=n)
    got = TS.save_quantum_dataset(X, Y, "tiny", output_dir=str(tmp_path / "port"))
    want = JS.save_quantum_dataset(X, Y, "tiny", output_dir=str(tmp_path / "jax"))
    assert os.path.basename(got) == os.path.basename(want) == f"tiny_{d}d_{n}.csv"
    with open(got, "rb") as fg, open(want, "rb") as fw:
        assert fg.read() == fw.read()
