from .partition import (  # noqa: F401
    sample_agent_data_percentage,
    split_data_numpy,
    train_test_split_np,
)
from .real_world import (  # noqa: F401
    SRTM_REGIONS,
    get_dataset_info,
    get_tile_for_region,
    load_real_world_dataset,
    load_robot_push_dataset,
    load_sea_surface_temperature,
    load_srtm_elevation_dataset,
    read_hgt_file,
)
from .synthetic import (  # noqa: F401
    generate_data_numpy,
    generate_quantum_gp_data,
    save_quantum_dataset,
)
