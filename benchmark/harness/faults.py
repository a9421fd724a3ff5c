"""Faults planted in the program under test, for the checks that the
comparison catches them (benchmark/tests and calibrate.py): each is a
context manager that patches one function of the port for its block.

  state_unchanged   a train step that returns its parameters unchanged
  half_batch        half of the frame's rows left out, the pixel loss the
                    mean over the rest
  altered_answer    every served frame and written BMP altered where it
                    is produced: a quarter-size block of it inverted
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch


@contextlib.contextmanager
def _patched(module, name, value):
    orig = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, orig)


def state_unchanged():
    import rendering_tpu_torch.diff.inverse as inverse

    orig = inverse.make_train_step

    def make(paths, optimizer=None, mesh=None, render_fn=None):
        init_fn, step_fn = orig(paths, optimizer=optimizer, mesh=mesh,
                                render_fn=render_fn)

        def frozen(params, opt, scene, target):
            saved = {k: v.detach().clone() for k, v in params.items()}
            params, opt, loss = step_fn(params, opt, scene, target)
            with torch.no_grad():
                for k, v in params.items():
                    v.copy_(saved[k])
            return params, opt, loss

        return init_fn, frozen

    return _patched(inverse, "make_train_step", make)


def half_batch():
    import rendering_tpu_torch.render.pipeline as pipeline

    orig = pipeline.render_scene

    def half(scene, *a, **kw):
        frame, aux = orig(scene, *a, **kw)
        return frame[:, :frame.shape[1] // 2], aux

    return _patched(pipeline, "render_scene", half)


def _alter(frame):
    out = np.array(frame, copy=True)
    h, w = out.shape[:2]
    out[:h // 4, :w // 4] = 255 - out[:h // 4, :w // 4]
    return out


@contextlib.contextmanager
def altered_answer():
    import rendering_tpu_torch.cli as cli
    import rendering_tpu_torch.render.pipeline as pipeline

    render, save = pipeline.render, cli.save_bmp

    def render_altered(scene, *a, **kw):
        frame, aux = render(scene, *a, **kw)
        return _alter(frame), aux

    def save_altered(path, frame):
        save(path, _alter(frame))

    with _patched(pipeline, "render", render_altered), \
            _patched(cli, "save_bmp", save_altered):
        yield


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "altered_answer": altered_answer}
# The faults each traffic kind's cells can have.
KIND_FAULTS = {"train": ("state_unchanged", "half_batch"),
               "scenefile": ("altered_answer",),
               "turntable": ("altered_answer",)}
