"""Bitwise-reproducible global reductions (the `reproduce_sum` contract),
PyTorch port.

Counterpart of gfdl_atmos_cubed_sphere_tpu/parallel/reductions.py (FV3
fv_grid_utils.F90 g_sum with reproduce=.true.): every element is quantized
to a 62-bit fixed-point integer relative to a power-of-two scale taken from
the largest magnitude, and the integers are summed. Integer addition is
exact in any order, so the sum is bit-identical for any element order and
equal to the JAX package's. The work runs in float64/int64 on the tensor's
own device whatever its working dtype. The cross-device form (a mesh axis)
waits for the multi-GPU port.
"""

import numpy as np
import torch

_BITS = 62          # fixed-point fraction bits
_SPLIT = 31         # low/high lane split so int64 partial sums cannot overflow


def reproduce_sum(x):
    """Deterministic sum of all elements of `x` as a 0-d float64 tensor:
    bit-identical for any element order; quantization error ~2^-62 x
    max|x| per element."""
    x = torch.as_tensor(x).to(torch.float64).reshape(-1)
    m = x.abs().max()
    # power-of-two scale: x / scale is an exact mantissa shift
    scale = torch.where(
        m > 0, 2.0 ** torch.ceil(torch.log2(torch.clamp(m, min=1e-300))),
        torch.ones_like(m))
    z = torch.round(x / scale * (2.0 ** _BITS)).to(torch.int64)
    hi = z >> _SPLIT                  # arithmetic shift: floor division
    lo = z - (hi << _SPLIT)
    total = (hi.sum().to(torch.float64) * (2.0 ** _SPLIT)
             + lo.sum().to(torch.float64))
    return total * scale * (2.0 ** -_BITS)


def g_sum_reproducible(field2d, area, mean=True):
    """Area-weighted reproducible global sum (mean when `mean`) of a
    per-tile 2-D field (fv_grid_utils.F90 g_sum:2879, reproduce=.true.)."""
    f64 = torch.float64
    num = reproduce_sum(torch.as_tensor(field2d).to(f64)
                        * torch.as_tensor(area).to(f64))
    if not mean:
        return num
    return num / reproduce_sum(area)


def checksum(x):
    """Order-independent integer state checksum (mpp_chksum analog): the
    sum of the raw IEEE bit patterns mod 2^64, as a 0-d int64 tensor.
    float32 is viewed as int32, then widened."""
    x = torch.as_tensor(x)
    if x.dtype == torch.float64:
        bits = x.contiguous().view(torch.int64)
    elif x.dtype == torch.float32:
        bits = x.contiguous().view(torch.int32).to(torch.int64)
    else:
        bits = x.to(torch.int64)
    return bits.reshape(-1).sum()


def checksum_host(x):
    """NumPy checksum with the same definition (for restart files)."""
    x = np.asarray(x)
    if x.dtype == np.float64:
        bits = x.view(np.int64)
    elif x.dtype == np.float32:
        bits = x.view(np.int32).astype(np.int64)
    else:
        bits = x.astype(np.int64)
    with np.errstate(over="ignore"):
        return int(np.sum(bits, dtype=np.int64))
