from repro_torch.checkpoint.checkpointer import (  # noqa: F401
    Checkpointer,
    install_preemption_hook,
)
