from rawaudiovae_kelsey_tpu_torch.observe.tb import EventWriter  # noqa: F401
from rawaudiovae_kelsey_tpu_torch.observe.logging import (  # noqa: F401
    Tee,
    tee_stdout,
)
from rawaudiovae_kelsey_tpu_torch.observe.spans import (  # noqa: F401
    span,
    spanned,
)
from rawaudiovae_kelsey_tpu_torch.observe.timing import (  # noqa: F401
    StepTimer,
    trace_capture,
)
