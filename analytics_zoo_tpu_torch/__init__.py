"""analytics-zoo on PyTorch and CUDA (NVIDIA Hopper).

A port of ``analytics_zoo_tpu`` beside it: plain tensor code is PyTorch,
and every kernel the JAX package wrote in Pallas is a kernel written by
hand for ``sm_90a`` (sources under ``csrc/``, built at first use).  The
package imports nothing of JAX.

Float32 products stay float32: TF32 is switched off for matmuls and
convolutions here, at import, so no entry point of the port silently
computes in three decimal digits.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# the JAX package's public names, exported from the same places (after the
# TF32 switch, so no import runs before it)
from analytics_zoo_tpu_torch.common.context import (  # noqa: E402,F401
    ZooConf, ZooContext, get_context, init_context)
from analytics_zoo_tpu_torch.common import dtypes  # noqa: E402,F401

__version__ = "0.1.0"
