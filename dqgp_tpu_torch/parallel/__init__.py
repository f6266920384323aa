from .consensus import (  # noqa: F401
    AgentBatch,
    admm_iteration,
    make_agent_batch,
    make_admm_step,
)
