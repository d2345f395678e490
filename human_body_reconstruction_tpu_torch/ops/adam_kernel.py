"""Adam's update of one parameter group: the CUDA pass (csrc/adam.cu, whose
note says what bounds it) and its plain version.

The update is optax's ``adam``/``adamw`` at a rate and bias corrections
given as 0-d f32 device tensors (``train/state.py`` ``AdamGroup``): mu = b1
mu + (1 - b1) g, nu = b2 nu + (1 - b2) g^2, p += -rate ((mu / bc1) /
(sqrt(nu / bc2) + eps) + weight_decay p).  ``update_plain`` writes it as
eleven foreach passes over the group, allocating two temporaries the size
of the group; ``hbr_adam_update`` takes the same f32 operations in the same
order in one pass that reads p, g, mu and nu once and writes p, mu and nu
once, so the two agree bit for bit on the card.  A gradient of ``None``
reads as zero: the plain version makes a zero tensor, the kernel takes a
null pointer.  The rate and corrections are read on the device, so the
update costs no host synchronisation and a CUDA graph captures it.

``update`` is the wrapper: for parameters on the CPU it runs the plain
version; for parameters on a CUDA device it launches the kernel (one launch
a group, unless the group has more tensors than one launch's parameter block
holds) or raises.  ``launches`` counts the host calls that launched it
(under a CUDA graph only the warm-up and the capture), ``fused_elements``
the elements the last of them updated.
"""

from __future__ import annotations

import ctypes

import torch

from human_body_reconstruction_tpu_torch.ops import cuda_lib

B1, B2 = 0.9, 0.999

launches = 0
fused_elements = 0


@torch.no_grad()
def update_plain(params, grads, exp_avg, exp_avg_sq, rate, bc1, bc2,
                 eps: float, weight_decay: float = 0.0):
    """The update as foreach passes, in place on params and the moments."""
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params, grads)]
    m, v = exp_avg, exp_avg_sq
    torch._foreach_mul_(m, B1)
    torch._foreach_add_(m, grads, alpha=1.0 - B1)
    torch._foreach_mul_(v, B2)
    torch._foreach_addcmul_(v, grads, grads, value=1.0 - B2)
    den = torch._foreach_div(v, bc2)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, eps)
    upd = torch._foreach_div(m, bc1)
    torch._foreach_div_(upd, den)
    if weight_decay:
        torch._foreach_add_(upd, params, alpha=weight_decay)
    torch._foreach_mul_(upd, -rate)
    torch._foreach_add_(params, upd)


def _check(params, grads, exp_avg, exp_avg_sq, scalars, device):
    """Raise unless every tensor is f32, contiguous and on ``device``, each
    gradient and moment the size of its parameter, each scalar one
    element."""
    for i, (p, g, m, v) in enumerate(zip(params, grads, exp_avg, exp_avg_sq)):
        for name, t in (("param", p), ("grad", g), ("exp_avg", m),
                        ("exp_avg_sq", v)):
            if t is None and name == "grad":
                continue
            if (t.dtype != torch.float32 or t.device != device
                    or not t.is_contiguous() or t.numel() != p.numel()):
                raise ValueError(
                    f"Adam kernel: {name} {i} must be a contiguous float32 "
                    f"tensor of {p.numel()} elements on {device}; got "
                    f"{t.dtype} {tuple(t.shape)} on {t.device}, strides "
                    f"{t.stride()}")
    for name, t in scalars.items():
        if t.dtype != torch.float32 or t.device != device or t.numel() != 1:
            raise ValueError(f"Adam kernel: {name} must be one float32 "
                             f"element on {device}; got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def update(params, grads, exp_avg, exp_avg_sq, rate, bc1, bc2, eps: float,
           weight_decay: float = 0.0):
    """One Adam update of a group, in place: ``params``, ``grads`` (entries
    may be None), ``exp_avg`` and ``exp_avg_sq`` parallel lists; ``rate``,
    ``bc1`` and ``bc2`` 0-d f32 tensors on the parameters' device."""
    global launches, fused_elements
    if not params:
        return
    device = params[0].device
    if device.type == "cpu":
        return update_plain(params, grads, exp_avg, exp_avg_sq, rate, bc1,
                            bc2, eps, weight_decay)
    if device.type != "cuda":
        raise ValueError(f"Adam kernel: unsupported device {device}")
    if not len(params) == len(grads) == len(exp_avg) == len(exp_avg_sq):
        raise ValueError("Adam kernel: params, grads and moments differ in "
                         "length")
    _check(params, grads, exp_avg, exp_avg_sq,
           {"rate": rate, "bc1": bc1, "bc2": bc2}, device)
    n = len(params)
    ptrs = ctypes.c_void_p * n
    code = cuda_lib.library().hbr_adam_update(
        n, ptrs(*[p.data_ptr() for p in params]),
        ptrs(*[None if g is None else g.data_ptr() for g in grads]),
        ptrs(*[m.data_ptr() for m in exp_avg]),
        ptrs(*[v.data_ptr() for v in exp_avg_sq]),
        (ctypes.c_longlong * n)(*[p.numel() for p in params]),
        rate.data_ptr(), bc1.data_ptr(), bc2.data_ptr(), B1, 1.0 - B1, B2,
        1.0 - B2, eps, weight_decay, cuda_lib.stream_handle(device))
    cuda_lib.check(code, "hbr_adam_update")
    launches += 1
    fused_elements = sum(p.numel() for p in params)
