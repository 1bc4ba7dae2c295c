"""Faults planted under the timed path, for the checks that the
comparison catches them: each is a context manager that patches the
program while it is open.

  * unchanged: every optimizer step is skipped, so a training step
    returns its parameters unchanged;
  * half_batch: the second half of every batch is replaced by the first
    half, so every mean is taken over half of the rows;
  * answer: infer's first image comes back with its first expression
    parameter moved by 0.1;
  * generator_lr: the generator's optimizer alone steps at 1.25 times
    its learning rate, so only a minority of the trained leaves move
    wrong.
"""
from __future__ import annotations

import contextlib
from unittest import mock


def _halve(t):
    if getattr(t, "ndim", 0) == 0 or t.shape[0] < 2:
        return t
    h = t.shape[0] // 2
    t = t.clone()
    t[h:2 * h] = t[:h]
    return t


@contextlib.contextmanager
def unchanged():
    with mock.patch("smirk_tpu_torch.train.trainer.adam_step", lambda *a, **k: None):
        yield


@contextlib.contextmanager
def half_batch():
    from smirk_tpu_torch.train.trainer import SmirkSystem

    batch_fn, body_fn = SmirkSystem._batch, SmirkSystem.infer_body

    def batch(self, b):
        return {k: _halve(v) for k, v in batch_fn(self, b).items()}

    def body(self, img):
        return body_fn(self, _halve(img))

    with mock.patch.object(SmirkSystem, "_batch", batch), \
            mock.patch.object(SmirkSystem, "infer_body", body):
        yield


@contextlib.contextmanager
def answer():
    from smirk_tpu_torch.train.trainer import SmirkSystem

    body_fn = SmirkSystem.infer_body

    def body(self, img):
        out = dict(body_fn(self, img))
        expr = out["expression_params"].clone()
        expr[0, 0] += 0.1
        out["expression_params"] = expr
        return out

    with mock.patch.object(SmirkSystem, "infer_body", body):
        yield


@contextlib.contextmanager
def generator_lr():
    from smirk_tpu_torch.train.trainer import SmirkSystem

    init = SmirkSystem.__init__

    def patched(self, *args, **kwargs):
        init(self, *args, **kwargs)
        lr = self.gen_lr
        self.gen_lr = lambda step: 1.25 * lr(step)

    with mock.patch.object(SmirkSystem, "__init__", patched):
        yield


FAULTS = {"unchanged": unchanged, "half_batch": half_batch, "answer": answer,
          "generator_lr": generator_lr}
