from .partition import sample_agent_data_percentage, split_data_numpy  # noqa: F401
