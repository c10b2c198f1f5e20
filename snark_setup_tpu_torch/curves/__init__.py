from .constants import CurveSpec, get_curve, CurveUnavailableError, AVAILABLE_CURVES
from .host import AffinePoint, HostCurve

__all__ = [
    "CurveSpec",
    "get_curve",
    "CurveUnavailableError",
    "AVAILABLE_CURVES",
    "AffinePoint",
    "HostCurve",
]
