"""repro_torch.serving — the LM `ServingEngine` and the online inverse
server `SpinService`, with its admission control and metrics."""

from ..core.precision import (PRECISION_PRESETS, PrecisionPolicy,
                              resolve_precision)
from .admission import AdmissionConfig, AdmissionRejected, Rejection
from .engine import Request, ServingEngine
from .metrics import PhaseLedger, Reservoir, ServiceMetrics
from .spin_service import (MatrixState, ResidencyBusy, SolveRequest,
                           SpinService, UpdateRequest)

__all__ = ["Request", "ServingEngine",
           "SpinService", "SolveRequest", "UpdateRequest", "MatrixState",
           "ResidencyBusy",
           "AdmissionConfig", "AdmissionRejected", "Rejection",
           "ServiceMetrics", "Reservoir", "PhaseLedger",
           # the serve-precision half of the API lives in core but is part
           # of the serving surface
           "PrecisionPolicy", "PRECISION_PRESETS", "resolve_precision"]
