"""Float64 references for holding a kernel pair against its plain version.

Shared by chip_smoke.py and tests/test_torch_cuda.py:

- :func:`net_grads` / :func:`net_outputs`: the outputs, and the gradients
  (parameters, then inputs) of sum(cot * out), of ``fn(net, *inputs)``, in
  point chunks so that a float64 reference at a path's full point count
  fits on the card;
- :func:`rel_errors`: each column's max |got - ref| over max |ref|;
- :func:`dense_copy`: a net with weight norm resolved, whose parameter
  gradients are the dense weight gradients a kernel computes;
- :func:`resolve_relu_ties`: the colour net's input cotangents in float64
  under the relu masks the kernel took at near-ties.
"""

from __future__ import annotations

import copy
import dataclasses

import torch

from ..fields.networks import ColorNetwork, WNLinear

RELU_TIE = 4e-6  # share of a pre-activation's term magnitudes within which f32 may flip its relu
MAX_TIES = 10  # near-tie units of one point whose masks resolve_relu_ties tries in every combination


def _chunks(n: int, chunk: int | None):
    step = n if chunk is None else chunk
    return [slice(s, min(s + step, n)) for s in range(0, n, step)]


def net_outputs(fn, net, ins, chunk: int | None = None) -> list[torch.Tensor]:
    """The outputs of fn(net, *ins) without a graph, evaluated ``chunk``
    points at a time and concatenated."""
    parts = []
    with torch.no_grad():
        for sl in _chunks(ins[0].shape[0], chunk):
            outs = fn(net, *[t[sl] for t in ins])
            parts.append(outs if isinstance(outs, tuple) else (outs,))
    return [torch.cat(c) for c in zip(*parts)]


def net_grads(fn, net, ins, cots, chunk: int | None = None):
    """(outputs, gradients) of sum(cot * out) over the outputs of
    fn(net, *ins); the gradients are the parameters' then the inputs', zeros
    for one that fn does not read. With ``chunk``, ``chunk`` points at a
    time: the outputs and input gradients concatenated, the parameter
    gradients summed."""
    params = list(net.parameters())
    outs, d_ins, d_params = [], [], None
    for sl in _chunks(ins[0].shape[0], chunk):
        xs = [t[sl].clone().requires_grad_(True) for t in ins]
        o = fn(net, *xs)
        o = o if isinstance(o, tuple) else (o,)
        loss = sum((a * c[sl]).sum() for a, c in zip(o, cots))
        g = torch.autograd.grad(loss, params + xs, allow_unused=True)
        g = [torch.zeros_like(t) if d is None else d for t, d in zip(params + xs, g)]
        gp = g[:len(params)]
        d_params = gp if d_params is None else [a + b for a, b in zip(d_params, gp)]
        d_ins.append(g[len(params):])
        outs.append([a.detach() for a in o])
        del o, loss, g
    return [torch.cat(c) for c in zip(*outs)], d_params + [torch.cat(c) for c in zip(*d_ins)]


def rel_errors(got, ref) -> list[float]:
    """For each pair, max |got - ref| over max |ref| (floored at 1e-12);
    inf where got is not finite."""
    out = []
    for a, b in zip(got, ref):
        a, b = a.detach().double(), b.detach().double()
        if not torch.isfinite(a).all():
            out.append(float("inf"))
            continue
        out.append(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-12))
    return out


def dense_copy(net: torch.nn.Module) -> torch.nn.Module:
    """A copy of net whose weight-normed linears hold their resolved (out,
    in) weights as plain parameters. The kernels compute the dense weight
    gradients and autograd projects them onto g and v after; a copy without
    that projection holds the kernels' own numbers."""
    out = copy.deepcopy(net)
    for m in out.modules():
        if isinstance(m, WNLinear) and m.weight_norm:
            w = m.dense().detach().clone()
            del m.g, m.v
            m.weight_norm = False
            m.w = torch.nn.Parameter(w)
    if dataclasses.is_dataclass(getattr(out, "cfg", None)) and hasattr(out.cfg, "weight_norm"):
        out.cfg = dataclasses.replace(out.cfg, weight_norm=False)
    return out


def _colour_forward(net: ColorNetwork, ins, flips=None):
    """ColorNetwork.forward in the inputs' dtype with each relu written as
    z * (z > 0), taken the other way where ``flips`` (one (P, H) bool per
    relu layer) is set. Returns the output, and each relu layer's
    pre-activation z and the sum of its terms' magnitudes
    (sum_j |w_kj h_j| + |b_k|)."""
    x, n, v, f = ins
    h = torch.cat({"idr": [x, v, n, f], "no_view_dir": [x, n, f],
                   "no_normal": [x, v, f]}[net.cfg.mode], -1)
    zs, mags = [], []
    for l, layer in enumerate(net.layers[:-1]):
        w, b = layer.dense(), layer.b
        z = h @ w.t() + b
        with torch.no_grad():
            mags.append(h.abs() @ w.abs().t() + b.abs())
        on = z.detach() > 0
        if flips is not None:
            on = on ^ flips[l]
        zs.append(z.detach())
        h = z * on
    out = net.layers[-1](h, h.dtype)
    if net.extra is not None:
        out = torch.cat([out, net.extra(h, h.dtype)], -1)
    return (torch.sigmoid(out) if net.cfg.squeeze_out else out), zs, mags


def resolve_relu_ties(net: ColorNetwork, ins, cot, got, ref, chunk: int | None = None):
    """The colour net's four input cotangents in float64, at each point
    where some relu pre-activation z lies within RELU_TIE of its terms'
    magnitudes (a near-tie: f32 rounding may take such a relu the other
    way, which moves that point's input cotangents by the unit's whole share
    while it leaves the forward unchanged) evaluated under the masks, among
    every way of taking that point's near-tie relus, that come nearest the
    kernel's ``got``. ``net`` is the float64 net, ``ins`` / ``cot`` its
    float64 inputs and output cotangent, ``ref`` the plain float64 input
    cotangents. Points without a near-tie keep ``ref``: a fault of the
    kernel shows there as it did.

    Returns (the resolved input cotangents, a report dict): the near-tie
    points, those the kernel took the other way, the most near-tie units
    at one point, and at the point farthest from ``ref`` (relative to each
    column's largest magnitude) its error against ``ref``, against the
    resolved reference and its number of flipped units. Raises ValueError
    when a point has more than MAX_TIES near-ties."""
    P = ins[0].shape[0]
    tie = torch.zeros(P, dtype=torch.bool, device=ins[0].device)
    with torch.no_grad():
        for sl in _chunks(P, chunk):
            _, zs, mags = _colour_forward(net, [t[sl] for t in ins])
            tie[sl] = torch.stack([(z.abs() <= RELU_TIE * m).any(-1) for z, m in zip(zs, mags)]).any(0)
    idx = tie.nonzero().squeeze(1)
    report = {"near_tie_points": int(idx.numel()), "taken_the_other_way": 0, "most_ties_at_a_point": 0}
    if idx.numel() == 0:
        return list(ref), report
    sub = [t[idx] for t in ins]
    with torch.no_grad():
        _, zs, mags = _colour_forward(net, sub)
    ties = torch.cat([z.abs() <= RELU_TIE * m for z, m in zip(zs, mags)], -1)  # (Pt, layers * H)
    n_ties = ties.sum(-1)
    most = int(n_ties.max())
    if most > MAX_TIES:
        raise ValueError(f"a point has {most} near-tie relus (more than {MAX_TIES})")
    ordinal = ties.cumsum(-1) - 1
    H = zs[0].shape[1]
    scale = torch.stack([r.abs().max().clamp_min(1e-30) for r in ref])  # each column's largest
    got_sub = [g[idx].double() for g in got]
    best_err = best_c = best = None
    for c in range(2 ** most):
        flip = ties & (((c >> ordinal.clamp_min(0)) & 1) == 1)
        flips = list(flip.split(H, -1))
        xs = [t.clone().requires_grad_(True) for t in sub]
        out, _, _ = _colour_forward(net, xs, flips)
        d = torch.autograd.grad((out * cot[idx]).sum(), xs, allow_unused=True)
        d = [torch.zeros_like(x) if g is None else g.detach() for x, g in zip(xs, d)]
        err = torch.stack([(a - b).abs().amax(-1) / s for a, b, s in zip(got_sub, d, scale)]).amax(0)
        if best is None:
            best_err, best_c, best = err, torch.zeros_like(n_ties), d
            err0 = err
            continue
        take = err < best_err
        best_err = torch.where(take, err, best_err)
        best_c = torch.where(take, torch.full_like(best_c, c), best_c)
        best = [torch.where(take[:, None], a, b) for a, b in zip(d, best)]
    out = [r.clone() for r in ref]
    for o, b in zip(out, best):
        o[idx] = b.to(o.dtype)
    worst = int(err0.argmax())
    flipped = ties[worst] & (((int(best_c[worst]) >> ordinal[worst].clamp_min(0)) & 1) == 1)
    report.update(taken_the_other_way=int((best_c != 0).sum()), most_ties_at_a_point=most,
                  worst_point_err_plain=float(err0[worst]), worst_point_err_resolved=float(best_err[worst]),
                  worst_point_units_flipped=int(flipped.sum()))
    return out, report
