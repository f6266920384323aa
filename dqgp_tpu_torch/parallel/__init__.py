from .consensus import (  # noqa: F401
    AgentBatch,
    admm_iteration,
    agent_updates,
    autodiff_nll_and_grad,
    make_agent_batch,
    make_admm_step,
)
