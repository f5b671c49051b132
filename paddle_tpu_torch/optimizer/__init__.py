"""Optimizers of the training path (counterpart of
``paddle_tpu/optimizer/__init__.py``): ``SGD``, ``Momentum``, ``Adam`` and
``AdamW``.

As in the JAX package each optimizer is a transform over a dict of
parameters keyed by the JAX parameter paths
(``paddle_tpu_torch.convert.param_tree``):

    state = opt.init(params)
    params, state = opt.apply_gradients(params, grads, state)

State is ``{accumulator name: {path: float32 tensor}}`` plus an int
``step``. Unlike the JAX transform, the update is done in place under
``torch.no_grad``: the returned dicts are the ones passed in, so a model's
``nn.Parameter``s train without a copy. ``apply_gradients(fused=True)``
routes the clip and update through the one-pass kernel of
``kernels/fused_update.py``; otherwise the gradients are clipped first and
each parameter takes ``fused_update.update_reference``, the kernel's
expression (and the JAX ``_update`` expressions) one PyTorch operation at
a time.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.kernels import fused_update as _fu
from paddle_tpu_torch.optimizer.clip import (GradientClipByGlobalNorm,
                                             global_norm)
from paddle_tpu_torch.optimizer.lr_scheduler import resolve as _resolve_lr

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW",
           "GradientClipByGlobalNorm", "global_norm"]


class Optimizer:
    """Base: learning-rate schedule, global-norm clip and step counter
    (``paddle_tpu/optimizer/__init__.py:35-125``). Regularization and the
    other clips of the JAX package are not ported."""

    def __init__(self, learning_rate=0.001, regularization=None,
                 grad_clip=None):
        if regularization is not None:
            raise NotImplementedError("regularization is not ported yet")
        if grad_clip is not None and not isinstance(
                grad_clip, GradientClipByGlobalNorm):
            raise NotImplementedError(
                "only GradientClipByGlobalNorm is ported")
        self.lr_fn = _resolve_lr(learning_rate)
        self.grad_clip = grad_clip

    def _accumulators(self):
        return _fu.ACC_NAMES[self._fused_spec()["kind"]]

    def init(self, params):
        state = {name: {k: torch.zeros_like(p, dtype=torch.float32)
                        for k, p in params.items()}
                 for name in self._accumulators()}
        state["step"] = 0
        return state

    def _fused_spec(self):
        raise NotImplementedError

    @torch.no_grad()
    def apply_gradients(self, params, grads, state, fused=False):
        """One step, in place, through the fused kernel when ``fused``.
        Returns ``(params, state)``."""
        step = state["step"]
        spec = self._fused_spec()
        if fused:
            clip = None if self.grad_clip is None else \
                self.grad_clip.clip_norm
            _fu.fused_update_step(params, grads, state, lr=self.lr_fn(step),
                                  step=step, clip_norm=clip, **spec)
        else:
            if self.grad_clip is not None:
                grads = self.grad_clip.apply(grads)
            kind = spec.pop("kind")
            device = next(iter(params.values())).device
            scal = _fu.step_scalars(self.lr_fn(step), step, kind,
                                    spec.get("beta1", 0.9),
                                    spec.get("beta2", 0.999), device=device)
            for k, p in params.items():
                _fu.update_reference(kind, p, grads[k],
                                     [state[nm][k] for nm in
                                      _fu.ACC_NAMES[kind]], scal, spec)
        state["step"] = step + 1
        return params, state

    def minimize(self, loss_fn, params, state, *args, has_aux=False,
                 fused=False):
        """``loss_fn(params, *args)`` -> loss (or ``(loss, aux)``); takes
        the gradient with respect to ``params`` and applies one step.
        Returns ``(loss, aux, params, state)`` with the loss detached."""
        out = loss_fn(params, *args)
        loss, aux = out if has_aux else (out, None)
        grads = torch.autograd.grad(loss, list(params.values()))
        self.apply_gradients(params, dict(zip(params, grads)), state, fused)
        return loss.detach(), aux, params, state


class SGD(Optimizer):
    """sgd_op."""

    def _fused_spec(self):
        return {"kind": "sgd"}


class Momentum(Optimizer):
    """momentum_op (use_nesterov attr)."""

    def __init__(self, learning_rate, momentum=0.9, use_nesterov=False, **kw):
        super().__init__(learning_rate, **kw)
        self.mu = momentum
        self.nesterov = use_nesterov

    def _fused_spec(self):
        return {"kind": "momentum", "momentum": self.mu,
                "nesterov": self.nesterov}


class Adam(Optimizer):
    """adam_op: bias-corrected, float32 moments."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self.b1, self.b2, self.eps = beta1, beta2, epsilon

    def _fused_spec(self):
        return {"kind": "adam", "beta1": self.b1, "beta2": self.b2,
                "epsilon": self.eps}


class AdamW(Adam):
    """Decoupled weight decay: Adam's step, then ``p -= lr * wd * p_old``."""

    def __init__(self, learning_rate=0.001, weight_decay=0.01, **kw):
        super().__init__(learning_rate, **kw)
        self.wd = weight_decay

    def _fused_spec(self):
        return dict(super()._fused_spec(), kind="adamw",
                    weight_decay=self.wd)
