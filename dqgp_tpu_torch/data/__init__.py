from .partition import (  # noqa: F401
    sample_agent_data_percentage,
    split_data_numpy,
    train_test_split_np,
)
from .synthetic import generate_data_numpy, generate_quantum_gp_data  # noqa: F401
