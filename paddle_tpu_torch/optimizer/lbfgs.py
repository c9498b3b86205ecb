"""L-BFGS (closure-based, full batch), with or without a strong-Wolfe
line search.

Mirrors ``paddle_tpu/optimizer/lbfgs.py``: the two-loop recursion over a
bounded history of (s, y) pairs, and Nocedal & Wright's Algorithms 3.5/3.6
(bracket, then zoom with safeguarded Hermite-cubic steps) on a small point
record (``_Pt``). The control flow is host Python, as in the JAX package:
every iteration calls the user's closure; the vectors are flat float32
tensors on the parameters' device, and the scalars that steer the search
(dot products, rates) are Python floats taken from them.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class _Pt:
    """One line-search evaluation: position t along d, value, directional
    derivative, and the full gradient at that point."""
    t: float
    val: float
    slope: float
    grad: object = None


def _cubic_min(a: _Pt, b: _Pt, lo_bound=None, hi_bound=None) -> float:
    """Minimizer of the Hermite cubic fitted to two (t, val, slope) records,
    clamped to [lo_bound, hi_bound] (defaults: the span of a and b). Falls
    back to the midpoint when the cubic has no real stationary minimum."""
    if lo_bound is None:
        lo_bound, hi_bound = sorted((a.t, b.t))
    theta = a.slope + b.slope - 3 * (a.val - b.val) / (a.t - b.t)
    disc = theta * theta - a.slope * b.slope
    if disc < 0:
        return 0.5 * (lo_bound + hi_bound)
    gamma = disc ** 0.5
    # express the root relative to the rightmost point so the formula is
    # branch-free after ordering
    lo, hi = (a, b) if a.t <= b.t else (b, a)
    span = hi.t - lo.t
    tstar = hi.t - span * (hi.slope + gamma - theta) / (
        hi.slope - lo.slope + 2 * gamma)
    return min(max(tstar, lo_bound), hi_bound)


def _strong_wolfe(obj_func, x, t, d, f, g, gtd, c1=1e-4, c2=0.9,
                  tolerance_change=1e-9, max_ls=25):
    """Strong-Wolfe line search. obj_func(x, t, d) -> (f, g) at x + t*d.
    Returns (f_new, g_new, t, n_evals).

    Phase 1 walks t forward (bounded cubic extrapolation) until it brackets
    a Wolfe point or satisfies both conditions outright; phase 2 shrinks the
    bracket with safeguarded cubic steps. `lo` always holds the best
    Armijo-satisfying end of the bracket, `hi` the other end.
    """
    scale = float(torch.max(torch.abs(d)))  # converts |Δt| to a parameter delta

    def probe(step):
        val, grad = obj_func(x, step, d)
        return _Pt(step, val, float(torch.dot(grad, d)), grad.clone())

    def armijo_ok(p):
        return p.val <= f + c1 * p.t * gtd

    def curvature_ok(p):
        return abs(p.slope) <= -c2 * gtd

    origin = _Pt(0.0, f, gtd, g.clone())
    prev, cur = origin, probe(t)
    evals = 1
    lo = hi = None
    satisfied = False

    # -- phase 1: bracket ----------------------------------------------------
    rounds = 0
    while rounds < max_ls:
        if not armijo_ok(cur) or (rounds > 1 and cur.val >= prev.val):
            lo, hi = prev, cur          # minimum is between them
            break
        if curvature_ok(cur):
            lo, hi = cur, cur
            satisfied = True
            break
        if cur.slope >= 0:
            lo, hi = prev, cur          # slope changed sign inside (prev, cur)
            break
        # still descending: extrapolate, at least 1% past cur, at most 10x
        nxt = _cubic_min(prev, cur,
                         lo_bound=cur.t + 0.01 * (cur.t - prev.t),
                         hi_bound=cur.t * 10)
        prev, cur = cur, probe(nxt)
        evals += 1
        rounds += 1
    else:
        lo, hi = origin, cur            # exhausted: whole walked range

    if lo.val > hi.val:
        lo, hi = hi, lo

    # -- phase 2: zoom -------------------------------------------------------
    nudged_last = False
    while not satisfied and rounds < max_ls:
        width = abs(hi.t - lo.t)
        if width * scale < tolerance_change:
            break
        cand = _cubic_min(lo, hi)
        # Keep candidates a safe margin inside the bracket. A candidate within
        # 10% of either edge is accepted once (progress may be genuine), but a
        # second consecutive edge-hugger — or one at/outside the bracket — is
        # pulled to the margin, guaranteeing the interval keeps shrinking.
        left, right = min(lo.t, hi.t), max(lo.t, hi.t)
        margin = 0.1 * width
        if min(right - cand, cand - left) < margin:
            if nudged_last or cand >= right or cand <= left:
                cand = (right - margin if abs(cand - right) < abs(cand - left)
                        else left + margin)
                nudged_last = False
            else:
                nudged_last = True
        else:
            nudged_last = False

        p = probe(cand)
        evals += 1
        rounds += 1
        if not armijo_ok(p) or p.val >= lo.val:
            hi = p                      # too high: shrink toward lo
            if lo.val > hi.val:
                lo, hi = hi, lo         # keep lo = lowest value seen
        else:
            if curvature_ok(p):
                satisfied = True
            elif p.slope * (hi.t - lo.t) >= 0:
                hi = lo                 # minimum is on lo's other side
            lo = p

    return lo.val, lo.grad, lo.t, evals


class LBFGS:
    """Use: ``opt.step(closure)``, where the closure clears the gradients,
    computes the loss, calls ``loss.backward()`` and returns the loss.
    ``weight_decay`` and ``grad_clip`` are accepted and not applied (fold
    regularization into the closure's loss), as in the JAX package."""

    def __init__(self, learning_rate=1.0, max_iter=20, max_eval=None,
                 tolerance_grad=1e-7, tolerance_change=1e-9, history_size=100,
                 line_search_fn=None, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        if max_eval is None:
            max_eval = max_iter * 5 // 4
        self._lr = float(learning_rate)
        self.max_iter = max_iter
        self.max_eval = max_eval
        self.tolerance_grad = tolerance_grad
        self.tolerance_change = tolerance_change
        self.history_size = history_size
        self.line_search_fn = line_search_fn
        self._parameter_list = list(parameters) if parameters is not None \
            else []
        self._weight_decay = weight_decay
        self._grad_clip = grad_clip
        self.state = {"func_evals": 0, "n_iter": 0}

    def get_lr(self):
        return self._lr

    # -- flat views -----------------------------------------------------------
    def _gather_flat_grad(self):
        parts = [(p.grad if p.grad is not None
                  else torch.zeros_like(p)).detach().reshape(-1).float()
                 for p in self._parameter_list]
        return torch.cat(parts) if parts else torch.zeros(0)

    @torch.no_grad()
    def _set_flat_params(self, flat):
        offset = 0
        for p in self._parameter_list:
            n = p.numel()
            p.copy_(flat[offset:offset + n].reshape(p.shape).to(p.dtype))
            offset += n

    def _gather_flat_params(self):
        return torch.cat([p.detach().reshape(-1).float()
                          for p in self._parameter_list])

    def clear_grad(self):
        for p in self._parameter_list:
            p.grad = None

    clear_gradients = clear_grad

    # -- checkpoint: the curvature history ------------------------------------
    def state_dict(self):
        def copy(v):
            return v.clone() if torch.is_tensor(v) else v
        return {"state": {k: [copy(e) for e in v] if isinstance(v, list)
                          else copy(v) for k, v in self.state.items()}}

    def set_state_dict(self, state):
        dev = self._parameter_list[0].device if self._parameter_list \
            else None

        def restored(v):
            if not hasattr(v, "shape"):
                return v
            t = v if torch.is_tensor(v) else torch.as_tensor(v)
            return t.to(device=dev, copy=True)

        self.state = {}
        for k, v in state.get("state", {}).items():
            if isinstance(v, list):
                self.state[k] = [restored(e) for e in v]
            elif getattr(v, "shape", ()) != ():
                self.state[k] = restored(v)
            else:
                self.state[k] = v
        self.state.setdefault("func_evals", 0)
        self.state.setdefault("n_iter", 0)

    # -- main -----------------------------------------------------------------
    def step(self, closure):
        """Up to ``max_iter`` iterations; returns the closure's first loss."""
        state = self.state
        orig_loss = closure()
        loss = float(orig_loss.detach())
        flat_grad = self._gather_flat_grad()
        current_evals = 1
        state["func_evals"] += 1
        if float(torch.max(torch.abs(flat_grad))) <= self.tolerance_grad:
            return orig_loss

        d = state.get("d")
        t = state.get("t")
        old_sk = state.setdefault("old_sk", [])
        old_yk = state.setdefault("old_yk", [])
        ro = state.setdefault("ro", [])
        H_diag = state.get("H_diag")
        prev_flat_grad = state.get("prev_flat_grad")
        prev_loss = state.get("prev_loss")

        n_iter = 0
        while n_iter < self.max_iter:
            n_iter += 1
            state["n_iter"] += 1

            if state["n_iter"] == 1:
                d = -flat_grad
                old_sk, old_yk, ro = [], [], []
                H_diag = 1.0
            else:
                y = flat_grad - prev_flat_grad
                s = d * t
                ys = float(torch.dot(y, s))
                if ys > 1e-10:
                    if len(old_yk) == self.history_size:
                        old_yk.pop(0)
                        old_sk.pop(0)
                        ro.pop(0)
                    old_yk.append(y)
                    old_sk.append(s)
                    ro.append(1.0 / ys)
                    H_diag = ys / float(torch.dot(y, y))
                num_old = len(old_yk)
                al = [0.0] * num_old
                q = -flat_grad
                for i in range(num_old - 1, -1, -1):
                    al[i] = float(torch.dot(old_sk[i], q)) * ro[i]
                    q = q - al[i] * old_yk[i]
                d = q * H_diag
                for i in range(num_old):
                    be_i = float(torch.dot(old_yk[i], d)) * ro[i]
                    d = d + old_sk[i] * (al[i] - be_i)

            prev_flat_grad = flat_grad
            prev_loss = loss

            # learning-rate selection
            if state["n_iter"] == 1:
                t = min(1.0, 1.0 / float(torch.sum(torch.abs(flat_grad)))) \
                    * self._lr
            else:
                t = self._lr

            gtd = float(torch.dot(flat_grad, d))
            if gtd > -self.tolerance_change:
                break

            ls_func_evals = 0
            if self.line_search_fn is not None:
                if self.line_search_fn != "strong_wolfe":
                    raise RuntimeError(
                        "only 'strong_wolfe' is supported as line_search_fn")
                x_init = self._gather_flat_params()

                def obj_func(x, t_, d_):
                    self._set_flat_params(x + t_ * d_)
                    self.clear_grad()
                    l_ = float(closure().detach())
                    return l_, self._gather_flat_grad()

                loss, flat_grad, t, ls_func_evals = _strong_wolfe(
                    obj_func, x_init, t, d, loss, flat_grad, gtd,
                    tolerance_change=self.tolerance_change)
                self._set_flat_params(x_init + t * d)
            else:
                self._set_flat_params(self._gather_flat_params() + t * d)
                if n_iter != self.max_iter:
                    self.clear_grad()
                    loss = float(closure().detach())
                    flat_grad = self._gather_flat_grad()
                    ls_func_evals = 1

            current_evals += ls_func_evals
            state["func_evals"] += ls_func_evals
            if current_evals >= self.max_eval:
                break
            if float(torch.max(torch.abs(flat_grad))) <= self.tolerance_grad:
                break
            if float(torch.max(torch.abs(d * t))) <= self.tolerance_change:
                break
            if abs(loss - prev_loss) < self.tolerance_change:
                break

        state.update(d=d, t=t, old_sk=old_sk, old_yk=old_yk, ro=ro,
                     H_diag=H_diag, prev_flat_grad=prev_flat_grad,
                     prev_loss=prev_loss)
        return orig_loss


__all__ = ["LBFGS"]
