"""Closeness predicates, streaming stats, sampling and uncertainty
propagation, Gauss-Jordan elimination and profiling hooks.

Port of ``surikatoko_tpu/utils``.
"""

from surikatoko_tpu_torch.utils import approx as approx
from surikatoko_tpu_torch.utils import la as la
from surikatoko_tpu_torch.utils import rand as rand
from surikatoko_tpu_torch.utils import stats as stats
