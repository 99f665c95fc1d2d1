"""Numpy runtime for ONNX graphs: the port's copy of
sam2unet_tpu/deploy/onnx_numpy.py over its own `interop.onnx_compat`.

The reference runs its exported .onnx under onnxruntime (test_onnx.py).
Where onnxruntime is not installed, `deploy/segmenter.py` and
`interop/export.verify_onnx` execute the graph here, in numpy and scipy
alone: a correctness backend, not a speed backend. It covers the op set
that `torch.onnx.export(..., dynamo=False)` emits for this package's
SAM2-UNet (the JAX package's copy covers the upstream module's graph): the
conv, attention, resize and norm ops, `If` control flow, and `Einsum`
(the port's resize matrices and attention products), plus the common
extras (Gemm, BatchNormalization, Sigmoid) so that other exports run too.

Opset semantics follow ONNX opset 13-17 (the versions torch 2.x emits).
"""

from __future__ import annotations

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view
from scipy.special import erf as _erf

from sam2unet_torch.interop import onnx_compat

# one shared DataType->numpy table
_CAST = dict(onnx_compat.DTYPES)


def _trunc_div(a, b):
    # ONNX integer Div truncates toward zero (C semantics); numpy's
    # floor_divide floors, which differs on mixed signs
    q = np.floor_divide(a, b)
    r = a - q * b
    return q + ((r != 0) & ((a < 0) != (b < 0)))


def _interp_taps(out_len, in_len, scale, mode, coord_mode, cubic_a,
                 nearest_mode="round_prefer_floor"):
    """1-D resize taps: (idx [out, k], w [out, k]) with clamped indices."""
    x = np.arange(out_len, dtype=np.float64)
    if coord_mode == "align_corners":
        src = x * ((in_len - 1) / (out_len - 1)) if out_len > 1 else np.zeros_like(x)
    elif coord_mode == "asymmetric":
        src = x / scale
    elif coord_mode in ("half_pixel", "pytorch_half_pixel"):
        src = (x + 0.5) / scale - 0.5
        if coord_mode == "pytorch_half_pixel" and out_len <= 1:
            src = np.zeros_like(x)
    else:
        raise NotImplementedError(f"coordinate_transformation_mode {coord_mode}")
    if mode == "nearest":
        # the spec default is round_prefer_floor (round-half-down), NOT
        # floor — flooring shifted every other index at 2x upsampling
        if nearest_mode == "round_prefer_floor":
            picked = np.ceil(src - 0.5)
        elif nearest_mode == "round_prefer_ceil":
            picked = np.floor(src + 0.5)
        elif nearest_mode == "floor":
            picked = np.floor(src)
        elif nearest_mode == "ceil":
            picked = np.ceil(src)
        else:
            raise NotImplementedError(f"nearest_mode {nearest_mode}")
        idx = np.clip(picked.astype(np.int64), 0, in_len - 1)
        return idx[:, None], np.ones((out_len, 1))
    base = np.floor(src).astype(np.int64)
    t = src - base
    if mode == "linear":
        offs = np.array([0, 1])
        w = np.stack([1 - t, t], axis=1)
    elif mode == "cubic":
        a = cubic_a
        offs = np.array([-1, 0, 1, 2])
        d = np.abs(t[:, None] - offs[None, :])  # distances, in [0, 2)
        w = np.where(
            d <= 1,
            ((a + 2) * d - (a + 3)) * d * d + 1,
            (((d - 5) * d + 8) * d - 4) * a,
        )
    else:
        raise NotImplementedError(f"resize mode {mode}")
    idx = np.clip(base[:, None] + offs[None, :], 0, in_len - 1)
    return idx, w


class NumpyOnnxRunner:
    """Execute an ONNX ModelProto with numpy. Call with a feed dict (or
    positional arrays in graph-input order); returns outputs by name."""

    def __init__(self, model):
        if isinstance(model, (str, bytes)):
            model = (
                onnx_compat.load_model(model)
                if isinstance(model, str)
                else onnx_compat.load_model_from_string(model)
            )
        self.model = model
        self.graph = model.graph
        self.weights = {
            t.name: onnx_compat.tensor_to_array(t) for t in self.graph.initializer
        }
        self.input_names = [
            i.name for i in self.graph.input if i.name not in self.weights
        ]
        self.output_names = [o.name for o in self.graph.output]

    # -- execution ---------------------------------------------------------

    def __call__(self, *args, **feeds):
        feeds.update(dict(zip(self.input_names, args)))
        missing = [n for n in self.input_names if n not in feeds]
        if missing:
            raise ValueError(f"missing graph inputs: {missing}")
        env = dict(self.weights)
        env.update({k: np.asarray(v) for k, v in feeds.items()})
        self._run_graph(self.graph, env)
        return {n: env[n] for n in self.output_names}

    def run(self, output_names, feeds):  # onnxruntime-style signature
        out = self(**feeds)
        names = output_names or self.output_names
        return [out[n] for n in names]

    def _io_infos(self, value_infos, names):
        class _Info:
            def __init__(self, name, shape):
                self.name, self.shape = name, shape

        by_name = {v.name: v for v in value_infos}
        infos = []
        for n in names:
            dims = []
            v = by_name.get(n)
            if v is not None and v.type.HasField("tensor_type"):
                for d in v.type.tensor_type.shape.dim:
                    dims.append(
                        int(d.dim_value) if d.HasField("dim_value") else d.dim_param
                    )
            infos.append(_Info(n, dims))
        return infos

    def get_inputs(self):  # onnxruntime-style metadata
        return self._io_infos(self.graph.input, self.input_names)

    def get_outputs(self):
        return self._io_infos(self.graph.output, self.output_names)

    def _run_graph(self, graph, env):
        # last-use positions so big activations free as execution advances
        last_use = {}

        def scan_uses(g, pos_of_node):
            for pos, node in enumerate(g.node):
                p = pos_of_node if pos_of_node is not None else pos
                for name in node.input:
                    if name:
                        last_use[name] = max(last_use.get(name, -1), p)
                for a in node.attribute:
                    if int(a.type) == 5:  # GRAPH: subgraph reads outer scope
                        scan_uses(a.g, p)

        scan_uses(graph, None)
        keep = set(self.weights) | {o.name for o in graph.output} | set(
            n for n in env
        )
        for pos, node in enumerate(graph.node):
            op = getattr(self, f"op_{node.op_type}", None)
            if op is None:
                raise NotImplementedError(f"ONNX op {node.op_type}")
            ins = [env[n] if n else None for n in node.input]
            attrs = onnx_compat.attr_map(node)
            self._cur_node = node  # ops needing output arity (Split) read it
            outs = op(attrs, *ins, env=env)
            if not isinstance(outs, tuple):
                outs = (outs,)
            for name, val in zip(node.output, outs):
                if name:
                    env[name] = val
            for name in node.input:
                if name and name not in keep and last_use.get(name) == pos:
                    env.pop(name, None)

    # -- elementwise / math ------------------------------------------------

    def op_Add(self, a, x, y, env=None):
        return x + y

    def op_Sub(self, a, x, y, env=None):
        return x - y

    def op_Mul(self, a, x, y, env=None):
        return x * y

    def op_Div(self, a, x, y, env=None):
        if np.issubdtype(np.asarray(x).dtype, np.integer):
            return _trunc_div(x, y)
        return x / y

    def op_Pow(self, a, x, y, env=None):
        return np.power(x, y).astype(np.asarray(x).dtype)

    def op_Sqrt(self, a, x, env=None):
        return np.sqrt(x)

    def op_Erf(self, a, x, env=None):
        return _erf(x).astype(np.asarray(x).dtype)

    def op_Exp(self, a, x, env=None):
        return np.exp(x)

    def op_Neg(self, a, x, env=None):
        return -x

    def op_Floor(self, a, x, env=None):
        return np.floor(x)

    def op_Tanh(self, a, x, env=None):
        return np.tanh(x)

    def op_Relu(self, a, x, env=None):
        return np.maximum(x, 0)

    def op_Sigmoid(self, a, x, env=None):
        return (1.0 / (1.0 + np.exp(-x))).astype(np.asarray(x).dtype)

    def op_Mod(self, a, x, y, env=None):
        if a.get("fmod", 0):
            return np.fmod(x, y)
        return np.mod(x, y)

    def op_Greater(self, a, x, y, env=None):
        return np.greater(x, y)

    def op_Less(self, a, x, y, env=None):
        return np.less(x, y)

    def op_Equal(self, a, x, y, env=None):
        return np.equal(x, y)

    def op_Where(self, a, c, x, y, env=None):
        return np.where(c, x, y)

    def op_Identity(self, a, x, env=None):
        return x

    def op_Cast(self, a, x, env=None):
        to = a["to"]
        if to == 16:  # bfloat16: numpy has no bf16 — round-to-nearest-even
            # to bf16 precision, carried as float32
            u = np.ascontiguousarray(x, np.float32).view(np.uint32)
            u = (u + 0x7FFF + ((u >> 16) & 1)) & np.uint32(0xFFFF0000)
            return u.view(np.float32)
        return np.asarray(x).astype(_CAST[to])

    def op_Softmax(self, a, x, env=None):
        ax = a.get("axis", -1)
        m = np.max(x, axis=ax, keepdims=True)
        e = np.exp(x - m)
        return (e / np.sum(e, axis=ax, keepdims=True)).astype(x.dtype)

    def op_ReduceMean(self, a, x, env=None):
        axes = tuple(a.get("axes", range(np.ndim(x))))
        return np.mean(x, axis=axes, keepdims=bool(a.get("keepdims", 1))).astype(
            x.dtype
        )

    def op_ReduceSum(self, a, x, axes=None, env=None):
        ax = tuple(axes.tolist()) if axes is not None else tuple(
            a.get("axes", range(np.ndim(x)))
        )
        return np.sum(x, axis=ax or None, keepdims=bool(a.get("keepdims", 1))).astype(
            x.dtype
        )

    # -- shape / structure -------------------------------------------------

    def op_Constant(self, a, env=None):
        if "value" in a:
            return a["value"]
        for k in ("value_float", "value_int"):
            if k in a:
                return np.asarray(a[k])
        if "value_floats" in a:
            return np.asarray(a["value_floats"], np.float32)
        if "value_ints" in a:
            return np.asarray(a["value_ints"], np.int64)
        raise NotImplementedError(f"Constant attrs {list(a)}")

    def op_ConstantOfShape(self, a, shape, env=None):
        val = a.get("value")
        fill = val.reshape(()) if val is not None else np.float32(0)
        return np.full(tuple(shape.astype(np.int64)), fill)

    def op_Shape(self, a, x, env=None):
        dims = np.asarray(np.shape(x), np.int64)
        start = a.get("start", 0)
        end = a.get("end", len(dims))
        return dims[start:end]

    def op_Size(self, a, x, env=None):
        return np.asarray(np.size(x), np.int64)

    def op_Reshape(self, a, x, shape, env=None):
        shape = list(shape.astype(np.int64))
        if not a.get("allowzero", 0):
            shape = [
                int(np.shape(x)[i]) if s == 0 else int(s)
                for i, s in enumerate(shape)
            ]
        return np.reshape(x, shape)

    def op_Transpose(self, a, x, env=None):
        return np.transpose(x, a.get("perm"))

    def op_Concat(self, a, *xs, env=None):
        return np.concatenate(xs, axis=a["axis"])

    def op_Split(self, a, x, split=None, env=None):
        axis = a.get("axis", 0)
        if split is None and "split" in a:
            split = np.asarray(a["split"])
        if split is None:
            # num_outputs only exists from opset 18; opset 13-17 equal
            # splits infer the count from the node's output list
            n = a.get("num_outputs") or sum(
                1 for o in self._cur_node.output if o
            )
            return tuple(np.array_split(x, n, axis=axis))
        pts = np.cumsum(split.astype(np.int64))[:-1]
        return tuple(np.split(x, pts, axis=axis))

    def op_Squeeze(self, a, x, axes=None, env=None):
        if axes is None and "axes" in a:
            axes = np.asarray(a["axes"])
        if axes is None:
            return np.squeeze(x)
        return np.squeeze(x, axis=tuple(int(v) for v in axes))

    def op_Unsqueeze(self, a, x, axes=None, env=None):
        if axes is None:
            axes = np.asarray(a["axes"])
        out = np.asarray(x)
        rank = out.ndim + len(axes)
        for ax in sorted(int(v) % rank for v in axes):
            out = np.expand_dims(out, ax)
        return out

    def op_Gather(self, a, x, idx, env=None):
        return np.take(x, idx.astype(np.int64), axis=a.get("axis", 0))

    def op_Slice(self, a, x, starts, ends, axes=None, steps=None, env=None):
        nd = np.ndim(x)
        starts = starts.astype(np.int64)
        ends = ends.astype(np.int64)
        axes = (
            axes.astype(np.int64) if axes is not None else np.arange(len(starts))
        )
        steps = steps.astype(np.int64) if steps is not None else np.ones_like(starts)
        sl = [slice(None)] * nd
        for s, e, ax, st in zip(starts, ends, axes, steps):
            sl[int(ax) % nd] = slice(int(s), int(e), int(st))
        return x[tuple(sl)]

    def op_Tile(self, a, x, reps, env=None):
        return np.tile(x, tuple(reps.astype(np.int64)))

    def op_Expand(self, a, x, shape, env=None):
        target = np.broadcast_shapes(np.shape(x), tuple(shape.astype(np.int64)))
        return np.broadcast_to(x, target)

    def op_Range(self, a, start, limit, delta, env=None):
        return np.arange(start, limit, delta)

    def op_Pad(self, a, x, pads=None, value=None, env=None):
        if pads is None:
            pads = np.asarray(a["pads"])
        pads = pads.astype(np.int64)
        nd = np.ndim(x)
        begin, end = pads[:nd], pads[nd:]
        # negative pads crop (torch emits them for centre crops)
        crop = tuple(
            slice(max(0, -int(b)), np.shape(x)[i] - max(0, -int(e)))
            for i, (b, e) in enumerate(zip(begin, end))
        )
        x = x[crop]
        widths = [(max(0, int(b)), max(0, int(e))) for b, e in zip(begin, end)]
        mode = a.get("mode", "constant")
        if mode == "constant":
            cv = 0 if value is None else np.asarray(value).reshape(())
            return np.pad(x, widths, constant_values=cv)
        return np.pad(x, widths, mode={"reflect": "reflect", "edge": "edge"}[mode])

    def op_If(self, a, cond, env=None):
        branch = a["then_branch"] if bool(np.asarray(cond).reshape(())) else a[
            "else_branch"
        ]
        # ONNX subgraphs read the outer scope but have their OWN namespace:
        # run in a child scope so branch intermediates can legally reuse
        # outer tensor names without clobbering them
        sub_env = dict(env)
        # branch subgraphs may carry their own initializers (exporters and
        # graph optimizers produce these) — seed them before running
        for t in branch.initializer:
            sub_env[t.name] = onnx_compat.tensor_to_array(t)
        self._run_graph(branch, sub_env)
        return tuple(sub_env[o.name] for o in branch.output)

    # -- NN ops ------------------------------------------------------------

    def op_MatMul(self, a, x, y, env=None):
        return np.matmul(x, y)

    def op_Einsum(self, a, *xs, env=None):
        # numpy's subscripts are ONNX's (letters, "...", an optional "->")
        return np.einsum(a["equation"].replace(" ", ""), *xs,
                         optimize=True).astype(np.asarray(xs[0]).dtype)

    def op_Gemm(self, a, x, y, c=None, env=None):
        if a.get("transA", 0):
            x = x.T
        if a.get("transB", 0):
            y = y.T
        out = a.get("alpha", 1.0) * (x @ y)
        if c is not None:
            out = out + a.get("beta", 1.0) * c
        return out.astype(np.asarray(x).dtype)

    @staticmethod
    def _resolve_pads(a, dims_in, k_eff, strides):
        """(top, left, bottom, right) honoring auto_pad — Conv and MaxPool
        share these semantics. SAME_* pads so out = ceil(in / stride);
        silently using pads=[0,0,0,0] for an auto_pad graph would return
        spatially wrong results."""
        ap = a.get("auto_pad", "NOTSET")
        if ap == "NOTSET":
            return tuple(a.get("pads", [0, 0, 0, 0]))
        if ap == "VALID":
            return 0, 0, 0, 0
        if ap not in ("SAME_UPPER", "SAME_LOWER"):
            raise NotImplementedError(f"auto_pad={ap!r}")
        per_axis = []
        for d, k, s in zip(dims_in, k_eff, strides):
            total = max((-(-d // s) - 1) * s + k - d, 0)
            small, big = total // 2, total - total // 2
            per_axis.append((small, big) if ap == "SAME_UPPER"
                            else (big, small))
        (pt, pb), (pl, pr) = per_axis
        return pt, pl, pb, pr

    def op_Conv(self, a, x, w, b=None, env=None):
        n, cin, h, wi = x.shape
        m, cg, kh, kw = w.shape
        g = a.get("group", 1)
        sh, sw = a.get("strides", [1, 1])
        dh, dw = a.get("dilations", [1, 1])
        khe, kwe = (kh - 1) * dh + 1, (kw - 1) * dw + 1
        pt, pl, pb, pr = self._resolve_pads(a, (h, wi), (khe, kwe), (sh, sw))
        xp = np.pad(x, ((0, 0), (0, 0), (pt, pb), (pl, pr)))
        win = sliding_window_view(xp, (khe, kwe), axis=(2, 3))
        win = win[:, :, ::sh, ::sw, ::dh, ::dw]  # (N, C, Ho, Wo, kh, kw)
        ho, wo = win.shape[2], win.shape[3]
        win = win.reshape(n, g, cg, ho, wo, kh, kw)
        cols = win.transpose(0, 1, 3, 4, 2, 5, 6).reshape(
            n, g, ho * wo, cg * kh * kw
        )
        wmat = w.reshape(g, m // g, cg * kh * kw)
        out = np.matmul(cols, wmat.transpose(0, 2, 1))  # (N, g, HoWo, M/g)
        out = out.transpose(0, 1, 3, 2).reshape(n, m, ho, wo)
        if b is not None:
            out = out + b[None, :, None, None]
        return out.astype(x.dtype)

    def op_MaxPool(self, a, x, env=None):
        kh, kw = a["kernel_shape"]
        sh, sw = a.get("strides", [1, 1])
        dh, dw = a.get("dilations", [1, 1])
        khe, kwe = (kh - 1) * dh + 1, (kw - 1) * dw + 1
        n_, c_, h_, w_ = x.shape
        pt, pl, pb, pr = self._resolve_pads(a, (h_, w_), (khe, kwe), (sh, sw))
        if a.get("ceil_mode", 0):
            # extend end-padding so the last (possibly partial) window exists
            ho = -(-(h_ + pt + pb - khe) // sh) + 1
            wo = -(-(w_ + pl + pr - kwe) // sw) + 1
            pb = max(pb, (ho - 1) * sh + khe - h_ - pt)
            pr = max(pr, (wo - 1) * sw + kwe - w_ - pl)
        xp = np.pad(
            x, ((0, 0), (0, 0), (pt, pb), (pl, pr)),
            constant_values=-np.inf if np.issubdtype(x.dtype, np.floating)
            else np.iinfo(x.dtype).min,
        )
        win = sliding_window_view(xp, (khe, kwe), axis=(2, 3))
        win = win[:, :, ::sh, ::sw, ::dh, ::dw]
        return win.max(axis=(-2, -1))

    def op_AveragePool(self, a, x, env=None):
        kh, kw = a["kernel_shape"]
        sh, sw = a.get("strides", [1, 1])
        n_, c_, h_, w_ = x.shape
        pt, pl, pb, pr = self._resolve_pads(a, (h_, w_), (kh, kw), (sh, sw))
        if a.get("ceil_mode", 0):
            ho = -(-(h_ + pt + pb - kh) // sh) + 1
            wo = -(-(w_ + pl + pr - kw) // sw) + 1
            pb = max(pb, (ho - 1) * sh + kh - h_ - pt)
            pr = max(pr, (wo - 1) * sw + kw - w_ - pl)
        xp = np.pad(x, ((0, 0), (0, 0), (pt, pb), (pl, pr)))
        win = sliding_window_view(xp, (kh, kw), axis=(2, 3))
        s = win[:, :, ::sh, ::sw].sum(axis=(-2, -1))
        if a.get("count_include_pad", 0):
            denom = float(kh * kw)
        else:
            ones = np.pad(np.ones((h_, w_), np.float64),
                          ((pt, pb), (pl, pr)))
            denom = sliding_window_view(ones, (kh, kw))[::sh, ::sw].sum(
                axis=(-2, -1)
            )
        return (s / denom).astype(x.dtype)

    def op_ConvTranspose(self, a, x, w, b=None, env=None):
        if a.get("auto_pad", "NOTSET") not in ("NOTSET", "VALID"):
            raise NotImplementedError("ConvTranspose auto_pad SAME_*")
        n, cin, h, wi = x.shape
        _, cog, kh, kw = w.shape  # (Cin, Cout/g, kh, kw)
        g = a.get("group", 1)
        sh, sw = a.get("strides", [1, 1])
        dh, dw = a.get("dilations", [1, 1])
        oph, opw = a.get("output_padding", [0, 0])
        khe, kwe = (kh - 1) * dh + 1, (kw - 1) * dw + 1
        pt, pl, pb, pr = tuple(a.get("pads", [0, 0, 0, 0]))
        # equivalent stride-1 conv: dilate the input by the stride, pad
        # fully (k_eff - 1) each side + output_padding at the end, run a
        # flipped-kernel conv, then crop by the declared pads — cropping
        # avoids negative-pad arithmetic entirely
        xd = np.zeros(
            (n, cin, (h - 1) * sh + 1 + oph, (wi - 1) * sw + 1 + opw),
            x.dtype,
        )
        xd[:, :, : (h - 1) * sh + 1 : sh, : (wi - 1) * sw + 1 : sw] = x
        cin_g = cin // g
        wf = w[:, :, ::-1, ::-1].reshape(g, cin_g, cog, kh, kw)
        wf = wf.transpose(0, 2, 1, 3, 4).reshape(g * cog, cin_g, kh, kw)
        out = self.op_Conv(
            {
                "group": g,
                "strides": [1, 1],
                "dilations": [dh, dw],
                "pads": [khe - 1, kwe - 1, khe - 1, kwe - 1],
            },
            xd, wf, b,
        )
        h_full, w_full = out.shape[2], out.shape[3]
        return out[:, :, pt : h_full - pb, pl : w_full - pr]

    def op_GlobalAveragePool(self, a, x, env=None):
        return np.mean(x, axis=(-2, -1), keepdims=True).astype(x.dtype)

    def op_BatchNormalization(self, a, x, scale, bias, mean, var, env=None):
        eps = a.get("epsilon", 1e-5)
        shape = (1, -1) + (1,) * (x.ndim - 2)
        return (
            (x - mean.reshape(shape))
            / np.sqrt(var.reshape(shape) + eps)
            * scale.reshape(shape)
            + bias.reshape(shape)
        ).astype(x.dtype)

    def op_LayerNormalization(self, a, x, scale, bias=None, env=None):
        ax = a.get("axis", -1)
        axes = tuple(range(ax % x.ndim, x.ndim))
        mu = np.mean(x, axis=axes, keepdims=True)
        var = np.var(x, axis=axes, keepdims=True)
        out = (x - mu) / np.sqrt(var + a.get("epsilon", 1e-5)) * scale
        if bias is not None:
            out = out + bias
        return out.astype(x.dtype)

    def op_Resize(self, a, x, roi=None, scales=None, sizes=None, env=None):
        mode = a.get("mode", "nearest")
        coord = a.get("coordinate_transformation_mode", "half_pixel")
        cubic_a = a.get("cubic_coeff_a", -0.75)
        nearest = a.get("nearest_mode", "round_prefer_floor")
        in_shape = np.asarray(x.shape, np.int64)
        if sizes is not None and np.size(sizes):
            out_shape = sizes.astype(np.int64)
            eff_scales = out_shape / in_shape
        else:
            eff_scales = np.asarray(scales, np.float64)
            out_shape = np.floor(in_shape * eff_scales).astype(np.int64)
        out = x
        for ax in range(x.ndim):
            if out_shape[ax] == in_shape[ax] and eff_scales[ax] == 1.0:
                continue
            idx, w = _interp_taps(
                int(out_shape[ax]), int(in_shape[ax]), float(eff_scales[ax]),
                mode, coord, cubic_a, nearest,
            )
            taps = np.take(out, idx, axis=ax)  # (..., out, k, ...)
            w_shape = [1] * taps.ndim
            w_shape[ax], w_shape[ax + 1] = w.shape
            out = (taps * w.reshape(w_shape)).sum(axis=ax + 1)
        return out.astype(x.dtype)
