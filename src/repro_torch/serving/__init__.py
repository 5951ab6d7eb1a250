"""Stereo serving engine with temporal warm start, and the LM wave engine
(counterpart of ``repro.serving``)."""
from repro_torch.serving.admission import AdmissionController  # noqa: F401
from repro_torch.serving.engine import Request, ServeEngine, decode_step  # noqa: F401
from repro_torch.serving.faults import (  # noqa: F401
    FaultInjected,
    FaultPlan,
    FaultSpec,
)
from repro_torch.serving.stereo_service import (  # noqa: F401
    CompletedFrame,
    FrameProgramCache,
    ServiceStats,
    StereoService,
)
from repro_torch.serving.warmstart import (  # noqa: F401
    WarmState,
    frame_thumbnail,
    prior_disagreement,
    scene_change_score,
)
