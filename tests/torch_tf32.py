"""tf32 rounding as the port's float32 flash kernels do it, in numpy, for
the tests that record why those kernels run 3xTF32."""
import numpy as np


def tf32_rna(x):
    """Round float32 to tf32 (10 mantissa bits), nearest, ties away from
    zero: the kernels' integer form of cvt.rna.tf32.f32."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def mm_tf32(a, b, passes):
    """a @ b with both operands rounded to tf32: one pass hi*hi, or three
    (hi*lo + lo*hi + hi*hi); products summed in float32."""
    ah, bh = tf32_rna(a), tf32_rna(b)
    if passes == 1:
        return ah @ bh
    al, bl = tf32_rna(a - ah), tf32_rna(b - bh)
    return (ah @ bl + al @ bh) + ah @ bh
