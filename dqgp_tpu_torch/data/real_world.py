"""Real-world dataset loaders: SST (synthetic oceanography), robot-push
(synthetic physics), SRTM 30m elevation (.hgt tiles).

Port of ``dqgp_tpu/data/real_world.py`` with the same formulas, the same
use of numpy's global RNG (``np.random.seed(random_state)`` then draws),
the same cleaning rules and normalization, so fixed seeds give the same
datasets as the JAX package and the reference. Host-side numpy; two
differences of means, not of results:

* ``standard_scale`` stands in for sklearn's ``StandardScaler`` (mean and
  the square root of the ddof-0 variance, a zero scale read as 1), because
  the card's host has no sklearn;
* ``read_hgt_file`` parses with ``np.frombuffer(..., ">i2")``, the JAX
  package's own fallback; its native C++ parser only speeds up reading a
  2.9-26 MB tile on the host and is not ported.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np


def download_file_if_not_exists(url: str, filename: str, description: str = "file"):
    """urllib fetch helper (real_world_datasets.py:17-28; unused by the SRTM
    path there too — tiles are expected on local disk)."""
    if not os.path.exists(filename):
        import urllib.request

        print(f"Downloading {description} from {url}...")
        urllib.request.urlretrieve(url, filename)
    return filename


def standard_scale(a: np.ndarray) -> np.ndarray:
    """sklearn's ``StandardScaler().fit_transform(a)`` for a 2-D float
    array: each column minus its mean, over the square root of its ddof-0
    variance; a column of zero variance keeps scale 1."""
    a = np.asarray(a, np.float64)
    mean = a.mean(axis=0)
    scale = np.sqrt(a.var(axis=0))
    scale[scale == 0.0] = 1.0
    return (a - mean) / scale


# --------------------------------------------------------------------------
# Sea surface temperature — real_world_datasets.py:30-120
# --------------------------------------------------------------------------


def load_sea_surface_temperature(
    data_dir: str = "./data",
    subsample_factor: int = 10,
    normalize: bool = True,
    random_state: int = 42,
    max_samples: Optional[int] = None,
    save_plot: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    np.random.seed(random_state)
    lat_min, lat_max = -70, 70
    lon_min, lon_max = -180, 180
    n_lat = max(10, int(140 / subsample_factor))
    n_lon = max(20, int(360 / subsample_factor))
    lats = np.linspace(lat_min, lat_max, n_lat)
    lons = np.linspace(lon_min, lon_max, n_lon)
    lat_grid, lon_grid = np.meshgrid(lats, lons, indexing="ij")

    temp = 28 - 0.4 * np.abs(lat_grid)
    temp += 4 * np.sin(np.radians(lon_grid) * 1.5) * np.exp(-0.02 * np.abs(lat_grid))
    temp += 2 * np.cos(np.radians(lat_grid) * 2.5) * np.sin(np.radians(lon_grid * 0.8))
    temp += 3 * np.sin(np.radians(lon_grid + lat_grid * 0.5))
    temp += (
        1.5 * np.sin(np.radians(lon_grid * 2)) * np.cos(np.radians(lat_grid))
        * np.exp(-0.5 * (lat_grid / 30) ** 2)
    )
    temp += 2 * np.exp(-((lat_grid - 40) ** 2 + (lon_grid - (-40)) ** 2) / 400)
    temp += 1.5 * np.exp(-((lat_grid + 30) ** 2 + (lon_grid - 20) ** 2) / 300)
    temp += np.random.normal(0, 0.8, temp.shape)

    X = np.column_stack([lat_grid.flatten(), lon_grid.flatten()])
    Y = temp.flatten()

    if max_samples is not None and len(X) > max_samples:
        indices = np.random.choice(len(X), max_samples, replace=False)
        X, Y = X[indices], Y[indices]

    if normalize:
        X = standard_scale(X)
        Y = standard_scale(Y.reshape(-1, 1)).flatten()
    return X, Y


# --------------------------------------------------------------------------
# Robot push — real_world_datasets.py:122-236
# --------------------------------------------------------------------------


def load_robot_push_dataset(
    data_dir: str = "./data",
    normalize: bool = True,
    random_state: int = 42,
    max_samples: Optional[int] = None,
    workspace_size: float = 2.0,
    include_force: bool = False,
    save_plot: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    np.random.seed(random_state)
    n_samples = 10000 if max_samples is None else min(max_samples, 50000)
    half_ws = workspace_size / 2
    obj_x = np.random.uniform(-half_ws, half_ws, n_samples)
    obj_y = np.random.uniform(-half_ws, half_ws, n_samples)
    push_angle = np.random.uniform(0, 2 * np.pi, n_samples)
    push_force = np.random.uniform(0.5, 5.0, n_samples)
    object_mass = np.random.uniform(0.1, 2.0, n_samples)

    friction_coeff = np.clip(
        0.2 + 0.3 * np.sin(obj_x * np.pi) * np.cos(obj_y * np.pi), 0.05, 0.8
    )
    max_static_friction = friction_coeff * object_mass * 9.81
    net_force = np.maximum(0, push_force - max_static_friction)
    acceleration = net_force / object_mass
    displacement_base = 0.5 * acceleration * 0.1**2
    angle_efficiency = 0.8 + 0.2 * np.cos(push_angle * 2)
    displacement_mag = displacement_base * angle_efficiency
    dist_from_center = np.sqrt(obj_x**2 + obj_y**2)
    displacement_mag *= 1.0 - 0.3 * np.exp(-2 * (half_ws - dist_from_center) ** 2)
    displacement_mag += 0.1 * np.sin(push_angle + np.arctan2(obj_y, obj_x))
    noise_std = 0.02 + 0.01 * displacement_mag
    Y = np.maximum(displacement_mag + np.random.normal(0, noise_std), 0.0)

    if include_force:
        X = np.column_stack([obj_x, obj_y, push_angle, push_force])
    else:
        X = np.column_stack([obj_x, obj_y, push_angle])

    if normalize:
        X = standard_scale(X)
        Y = standard_scale(Y.reshape(-1, 1)).flatten()
    return X, Y


# --------------------------------------------------------------------------
# SRTM elevation — real_world_datasets.py:238-572
# --------------------------------------------------------------------------

SRTM_REGIONS = {
    "maharashtra": {
        "tile": "N17E073",
        "bounds": {"lat_min": 17.0, "lat_max": 18.0, "lon_min": 73.0, "lon_max": 74.0},
        "allow_negative": False,
        "elevation_limits": (0, 2000),
    },
    "great_lakes": {
        "tile": "N43W080",
        "bounds": {"lat_min": 43.0, "lat_max": 44.0, "lon_min": -80.0, "lon_max": -79.0},
        "allow_negative": False,
        "elevation_limits": (75, 600),
    },
    "oregon_coast": {
        "tile": "N45W123",
        "bounds": {"lat_min": 45.0, "lat_max": 46.0, "lon_min": -123.0, "lon_max": -122.0},
        "allow_negative": False,
        "elevation_limits": (0, 1500),
    },
    "washington_coast": {
        "tile": "N47W124",
        "bounds": {"lat_min": 47.0, "lat_max": 48.0, "lon_min": -124.0, "lon_max": -123.0},
        "allow_negative": False,
        "elevation_limits": (0, 3000),
    },
}


def read_hgt_file(hgt_path: str) -> np.ndarray:
    """Parse a raw SRTM .hgt tile: big-endian int16, 3601^2 (1 arc-sec) or
    1201^2 (3 arc-sec), size-sniffed (real_world_datasets.py:527-572).
    Returns float64 (n, n)."""
    file_size = os.path.getsize(hgt_path)
    if file_size == 25934402:
        n = 3601
    elif file_size == 2884802:
        n = 1201
    else:
        raise ValueError(f"Unexpected HGT file size: {file_size} bytes")
    with open(hgt_path, "rb") as f:
        data = f.read()
    return np.frombuffer(data, dtype=">i2").reshape(n, n).astype(np.float64)


def get_tile_for_region(region: str) -> str:
    return SRTM_REGIONS.get(region, {}).get("tile", region)


def load_srtm_elevation_dataset(
    region: str = "maharashtra",
    max_samples: int = 5000,
    subsample_factor: int = 10,
    normalize: bool = True,
    random_state: int = 42,
    save_plot: bool = False,
    use_preprocessed: bool = False,
    data_dir: str = "srtm_data",
    preprocessed_dir: str = "srtm/preprocessed",
) -> Tuple[np.ndarray, np.ndarray]:
    if region not in SRTM_REGIONS:
        raise ValueError(
            f"Region '{region}' not supported. Available: {list(SRTM_REGIONS)}"
        )
    info = SRTM_REGIONS[region]
    bounds, tile = info["bounds"], info["tile"]

    if use_preprocessed:
        path = os.path.join(preprocessed_dir, f"{tile}.npy")
        if not os.path.exists(path):
            raise FileNotFoundError(f"Preprocessed file not found: {path}")
        elevation = np.load(path)
        if elevation.shape[0] != elevation.shape[1]:
            raise ValueError(f"Unexpected preprocessed data shape: {elevation.shape}")
    else:
        path = os.path.join(data_dir, f"{tile}.hgt")
        if not os.path.exists(path):
            alt = os.path.join(data_dir, f"{tile}.SRTMGL1.hgt")
            if os.path.exists(alt):
                path = alt
            else:
                raise FileNotFoundError(
                    f"HGT file not found for tile {tile} in "
                    f"{os.path.abspath(data_dir)}. Place a real SRTM tile "
                    f"there, or generate synthetic stand-in tiles with "
                    f"`python scripts/make_synthetic_tiles.py {data_dir}`."
                )
        elevation = read_hgt_file(path)

    n_rows, n_cols = elevation.shape
    lats = np.linspace(bounds["lat_max"], bounds["lat_min"], n_rows)  # N -> S
    lons = np.linspace(bounds["lon_min"], bounds["lon_max"], n_cols)  # W -> E
    lon_grid, lat_grid = np.meshgrid(lons, lats)

    if subsample_factor > 1:
        lat_grid = lat_grid[::subsample_factor, ::subsample_factor]
        lon_grid = lon_grid[::subsample_factor, ::subsample_factor]
        elevation = elevation[::subsample_factor, ::subsample_factor]

    X = np.column_stack([lat_grid.flatten(), lon_grid.flatten()])
    Y = elevation.flatten()

    valid = (Y != -32768) & ~np.isnan(Y) & ~np.isinf(Y)
    X, Y = X[valid], Y[valid]

    if not info["allow_negative"] and np.sum(Y < 0) > 0:
        pos = Y >= 0
        X, Y = X[pos], Y[pos]

    min_elev, max_elev = info["elevation_limits"]
    keep = (Y >= min_elev) & (Y <= max_elev)
    X, Y = X[keep], Y[keep]

    if len(Y) > max_samples:
        np.random.seed(random_state)
        indices = np.random.choice(len(Y), size=max_samples, replace=False)
        X, Y = X[indices], Y[indices]

    if normalize:
        # Attentive-Kernels style: X MinMax -> (-1, 1), Y standardized
        # (real_world_datasets.py:483-509)
        X_min = X.min(axis=0, keepdims=True)
        X_max = X.max(axis=0, keepdims=True)
        X = 2.0 * (X - X_min) / (X_max - X_min) - 1.0
        Y = standard_scale(Y.reshape(-1, 1)).flatten()
    return X, Y


# --------------------------------------------------------------------------
# Dispatch + metadata — real_world_datasets.py:802-886
# --------------------------------------------------------------------------

_ALIASES = {
    "sst": "sst",
    "sea_surface_temperature": "sst",
    "robot_push": "robot_push",
    "robot": "robot_push",
    "push": "robot_push",
    "srtm": "srtm_elevation",
    "elevation": "srtm_elevation",
    "srtm_elevation": "srtm_elevation",
}


def load_real_world_dataset(name: str, **kwargs) -> Tuple[np.ndarray, np.ndarray]:
    key = _ALIASES.get(name.lower())
    if key is None:
        raise ValueError(f"Unknown real-world dataset '{name}'. Available: {sorted(set(_ALIASES.values()))}")
    if key == "sst":
        return load_sea_surface_temperature(**kwargs)
    if key == "robot_push":
        return load_robot_push_dataset(**kwargs)
    return load_srtm_elevation_dataset(**kwargs)


def get_dataset_info():
    return {
        "sst": {
            "name": "Sea Surface Temperature",
            "dimensions": 2,
            "input_desc": "latitude, longitude",
            "output_desc": "temperature (C)",
            "source": "synthetic oceanographic patterns",
        },
        "robot_push": {
            "name": "Robot Push",
            "dimensions": 3,
            "input_desc": "object x, object y, push angle",
            "output_desc": "displacement (m)",
            "source": "synthetic contact physics",
        },
        "srtm_elevation": {
            "name": "SRTM Elevation",
            "dimensions": 2,
            "input_desc": "latitude, longitude",
            "output_desc": "elevation (m)",
            "source": "NASA SRTM 30m tiles (Attentive Kernels regions)",
        },
    }
