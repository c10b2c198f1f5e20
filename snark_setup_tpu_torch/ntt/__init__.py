"""Number-theoretic transforms over scalar fields and group elements.

Reference capability: ark-poly `GeneralEvaluationDomain::ifft` applied to
projective curve points inside `Groth16Params::new`
(setup-utils/src/groth16_utils.rs:44-53). Here each butterfly stage is one
batched GLV scalar-mul of half the points by host-made twiddles plus two
batched group adds, on the port's kernels (K3 + K4, K2) on the card.
"""

from .domain import Radix2Domain, domain_size, fr_generator
from .group_fft import GroupFFT, group_fft, h_query_device

__all__ = ["Radix2Domain", "domain_size", "fr_generator", "GroupFFT", "group_fft", "h_query_device"]
