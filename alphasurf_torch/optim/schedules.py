"""Learning-rate and hyperparameter schedules: a copy of the JAX package's
``optim.schedules`` (svox2's opt/util/util.py:102-181: JaxNeRF exponential
decay with delayed warm-up, linear-then-exponential, linear). They run on
the host each step and feed Python floats into the train step
(opt.py:693-743).
"""
from __future__ import annotations

import numpy as np


def expon_lr_func(
    lr_init, lr_final, lr_delay_steps=0, lr_delay_mult=1.0,
    max_steps=1000000, fix_delay_step=0,
):
    def helper(step):
        if step < 0 or (lr_init == 0.0 and lr_final == 0.0):
            return 0.0
        step = step - fix_delay_step
        if step < 0:
            return lr_init * lr_delay_mult if lr_delay_mult > 0 else lr_init
        if lr_delay_steps > 0:
            delay_rate = lr_delay_mult + (1 - lr_delay_mult) * np.sin(
                0.5 * np.pi * np.clip(step / lr_delay_steps, 0, 1)
            )
        else:
            delay_rate = 1.0
        t = np.clip(step / max_steps, 0, 1)
        log_lerp = np.exp(np.log(lr_init) * (1 - t) + np.log(lr_final) * t)
        return float(delay_rate * log_lerp)

    return helper


def linear_expon_lr_func(
    lr_init, lr_final, lr_delay_steps=0, lr_delay_mult=1.0,
    max_steps=1000000, fix_delay_step=0,
):
    def helper(step):
        if step < 0 or (lr_init == 0.0 and lr_final == 0.0):
            return 0.0
        step = step - fix_delay_step
        if step < 0:
            return lr_init * lr_delay_mult if lr_delay_mult > 0 else lr_init
        if step < lr_delay_steps:
            return float(
                ((1 - lr_delay_mult) * step / lr_delay_steps + lr_delay_mult)
                * lr_init
            )
        step = step - lr_delay_steps
        t = np.clip(step / max_steps, 0, 1)
        return float(np.exp(np.log(lr_init) * (1 - t) + np.log(lr_final) * t))

    return helper


def linear_lr_func(lr_init, lr_final, lr_delay_steps=0, max_steps=1000000):
    def helper(step):
        if step < 0 or (lr_init == 0.0 and lr_final == 0.0):
            return 0.0
        if step <= lr_delay_steps:
            return float(lr_init)
        if step >= max_steps:
            return float(lr_final)
        rate = (lr_final - lr_init) / max_steps
        return float(lr_init + rate * (step - lr_delay_steps))

    return helper


def make_decay_func(kind: str, init, final, delay_steps=0, delay_mult=1.0,
                    max_steps=1000000, fix_delay_step=0):
    """Dispatch on the decay type strings used by the reference configs
    (opt.py:205-267: 'expon' | 'linear' | 'linear_expon' | 'const')."""
    if kind in ("const", None):
        return lambda step: float(init)
    if kind == "linear":
        return linear_lr_func(init, final, delay_steps, max_steps)
    if kind == "linear_expon":
        return linear_expon_lr_func(init, final, delay_steps, delay_mult,
                                    max_steps, fix_delay_step)
    return expon_lr_func(init, final, delay_steps, delay_mult, max_steps,
                         fix_delay_step)
