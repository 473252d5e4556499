"""Convolutions whose backward pass reads an int8 copy of their input,
the counterpart of `ursonet_tpu/models/actq.py` (`conv_q8saved`,
`conv_q8wgrad8`, `ConvQ8`; config TRAIN_ACT_Q8).

  * The forward is the plain conv's, exact: `ConvQ8` computes what the
    port's `Conv2d` computes (a bf16 input meets the f32 weight and bias
    cast to bf16, the bias added after the product; an input of the
    weight's type runs F.conv2d with the bias). The input is quantized
    per sample to int8 (`quant_s8` 'x') and the backward keeps
    (q, scale, w), never x.
  * dx is exact: the transposed conv of the same weight
    (aten.convolution_backward, cuDNN on the card, as XLA computes it in
    the JAX package); the bias gradient comes from the same call.
  * dw, mode True: the weight gradient of the dequantized copy
    (`quant_s8` 'dequant', bf(q) * bf(scale) in the compute type).
  * dw, mode 'wgrad8': the output gradient is quantized too (`quant_s8`
    'g': the per-sample scale folded into g, one global scale sg), and dw
    is the int8 x int8 -> int32 product of the saved q and qg
    (`wgrad_s8`), times sg, in the compute type. Where the contraction's
    worst case could pass int32 (N * Ho * Wo > INT32_SAFE_ACC, N the
    global batch), the dequant route of mode True runs instead: JAX's
    shape branch, decided from the shapes in the forward, which then
    saves q in the layout its backward reads (`actq_cuda.wgrad_plan`:
    rows padded for TMA on the 'tma' route, plain NCHW otherwise).

Under a mesh whose 'data' axis splits (`data_group`, set by
`parallel/sharding.py::shard_model`), the g-scale is the global batch's
(quant_s8 all-reduces its max over the group) and the int32 guard reads
the global batch (local N x `data_size`), as the JAX package's GSPMD step
sees them.

Outside autograd (no_grad, or no input needing a gradient) `ConvQ8` runs
the plain forward alone, as JAX runs a custom_vjp's primal.
"""

from __future__ import annotations

import torch

from ursonet_torch.models.resnet import Conv2d
from ursonet_torch.ops import actq_cuda

MODES = (True, 'wgrad8')


def _pads(padding):
    (ph, pw) = padding
    return ((ph, ph), (pw, pw))


def _dx_db(ctx, g, w, shape):
    """Exact input and bias gradients: the transposed conv of `w`."""
    want_x, want_b = ctx.needs_input_grad[0], ctx.has_bias \
        and ctx.needs_input_grad[2]
    if not (want_x or want_b):
        return None, None
    x_meta = g.new_empty(1).expand(shape)
    dx, _, db = torch.ops.aten.convolution_backward(
        g, x_meta, w, [w.shape[0]] if ctx.has_bias else None,
        ctx.stride, ctx.padding, [1, 1], False, [0, 0], 1,
        [want_x, False, want_b])
    return dx, db


def _dw_dequant(ctx, g, q, scale, w):
    xf = actq_cuda.quant_s8(q, 'dequant', scale, dtype=w.dtype)
    _, dw, _ = torch.ops.aten.convolution_backward(
        g, xf, w, None, ctx.stride, ctx.padding, [1, 1], False, [0, 0], 1,
        [False, True, False])
    return dw


class ConvQ8Fn(torch.autograd.Function):
    """y = conv2d(x, w, b) with (q, scale, w) saved for the backward
    (module docstring). `stride` and `padding` are F.conv2d's pairs."""

    @staticmethod
    def forward(ctx, x, w, b, stride, padding, mode, group, data_size):
        y = torch.nn.functional.conv2d(x, w, b, stride, padding)
        # the int8 route of 'wgrad8' (JAX's int32 guard on the global
        # batch) saves q in the layout its weight-gradient kernel reads
        n, ho, wo = y.shape[0], y.shape[2], y.shape[3]
        plan = None
        if mode == 'wgrad8' and ctx.needs_input_grad[1] \
                and n * data_size * ho * wo <= actq_cuda.INT32_SAFE_ACC:
            plan = actq_cuda.wgrad_plan(tuple(x.shape), w.shape[0],
                                        tuple(w.shape[2:]), stride[0],
                                        _pads(padding))
        q, scale = actq_cuda.quant_s8(x.contiguous(), 'x', plan=plan)
        ctx.save_for_backward(q, scale, w)
        ctx.stride, ctx.padding = list(stride), list(padding)
        ctx.mode, ctx.group, ctx.plan = mode, group, plan
        ctx.x_shape = x.shape       # q's own shape may be its plan's layout
        ctx.has_bias = b is not None
        return y

    @staticmethod
    def backward(ctx, g):
        q, scale, w = ctx.saved_tensors
        g = g.contiguous()
        dx, db = _dx_db(ctx, g, w, ctx.x_shape)
        dw = None
        plan = ctx.plan
        if ctx.needs_input_grad[1]:
            if plan is not None:
                co, ci, kh, kw = w.shape
                qgt, alpha = actq_cuda.quant_s8(
                    g, 'g', scale, group=ctx.group, alpha_len=ci * kh * kw,
                    plan=plan)
                dw = actq_cuda.wgrad_s8(q, qgt, (kh, kw), ctx.stride[0],
                                        _pads(ctx.padding), alpha, plan=plan)
                dw = dw.to(w.dtype)
            else:
                dw = _dw_dequant(ctx, g, q, scale, w)
        return dx, dw, db, None, None, None, None, None


class ConvQ8(Conv2d):
    """The port's Conv2d with int8 saved activations: the same
    parameters, names and forward; `mode` True or 'wgrad8'. Square
    strides and symmetric padding, as every backbone conv has (a conv
    whose padding is written out runs over the padded input)."""

    def __init__(self, *args, mode=True, **kwargs):
        super().__init__(*args, **kwargs)
        if mode not in MODES:
            raise ValueError(f"ConvQ8 mode must be True or 'wgrad8' "
                             f"(got {mode!r})")
        if self.stride[0] != self.stride[1] or self.groups != 1 \
                or self.dilation != (1, 1) or isinstance(self.padding, str):
            raise ValueError("ConvQ8 takes square strides, explicit "
                             "padding, no groups and no dilation")
        self.mode = mode
        self.data_group = None
        self.data_size = 1

    def forward(self, x):
        if not (torch.is_grad_enabled()
                and (x.requires_grad or self.weight.requires_grad)):
            return super().forward(x)
        args = (self.stride, self.padding, self.mode, self.data_group,
                self.data_size)
        if x.dtype == self.weight.dtype:
            return ConvQ8Fn.apply(x, self.weight, self.bias, *args)
        y = ConvQ8Fn.apply(x, self.weight.to(x.dtype), None, *args)
        if self.bias is None:
            return y
        return y + self.bias.to(x.dtype)[:, None, None]
