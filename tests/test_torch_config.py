"""RenderConfig of the PyTorch port against the JAX package's: the same
fields, the same resolution of step_relax and prime_ds, the same rejections."""

import dataclasses

import pytest
import torch

from gpgpuraytrace_tpu.models.scene import RenderConfig as JaxConfig
from gpgpuraytrace_tpu_torch.models.scene import RenderConfig

torch.set_num_threads(2)

SIZES = [(64, 128), (512, 512), (63, 64), (40, 40), (128, 96), (120, 64),
         (56, 64), (1080, 1920)]


def _pair(**kw):
    """(port config, JAX config) from the port's keyword names."""
    jkw = dict(kw)
    if "use_kernel" in jkw:
        jkw["use_pallas"] = jkw.pop("use_kernel")
    return RenderConfig(**kw), JaxConfig(**jkw)


RENAMED = {"use_pallas": "use_kernel", "pallas_bwd": "kernel_bwd"}


def test_fields_mirror_jax():
    port = [f.name for f in dataclasses.fields(RenderConfig)]
    jax_fields = [
        RENAMED.get(f.name, f.name)
        for f in dataclasses.fields(JaxConfig)
        if f.name != "interpret"
    ]
    assert port == jax_fields
    back = {v: k for k, v in RENAMED.items()}
    for f in dataclasses.fields(RenderConfig):
        jname = back.get(f.name, f.name)
        assert f.default == JaxConfig.__dataclass_fields__[jname].default, f.name
    with pytest.raises(dataclasses.FrozenInstanceError):
        RenderConfig().height = 3


@pytest.mark.parametrize("volumetric", [False, True])
@pytest.mark.parametrize("mode", ["chunked", "fixed", "lod", "compact"])
def test_resolution_matches_jax(mode, volumetric):
    for h, w in SIZES:
        for use_kernel in (True, False):
            port, ref = _pair(height=h, width=w, march_mode=mode,
                              volumetric=volumetric, use_kernel=use_kernel)
            assert port.step_relax == ref.step_relax
            assert port.prime_ds == ref.prime_ds, (h, w, mode)
            # Resolution survives dataclasses.replace, as the oracle
            # harnesses use it.
            port2 = dataclasses.replace(port, march_mode="fixed")
            ref2 = dataclasses.replace(ref, march_mode="fixed")
            assert port2.prime_ds == ref2.prime_ds == 0


@pytest.mark.parametrize(
    "kw",
    [
        {"max_steps": 100},
        {"max_steps": 128, "march_chunk": 7},
        {"max_steps": 100, "march_chunk": 0},
        {"march_chunk": -1},
        {"newton_iters": 0},
        {"prime_ds": 1},
        {"prime_ds": 6},
        {"prime_ds": 8, "prime_margin": 0.0},
        {"prime_ds": 8, "prime_margin": 1.5},
        {"march_mode": "compact", "compact_budget": 12},
        {"march_mode": "compact", "compact_budget": 128},
        # Valid configs: both packages accept them.
        {"max_steps": 100, "use_kernel": False},
        {"max_steps": 100, "march_mode": "fixed"},
        {"prime_ds": 8, "prime_margin": 1.0},
        {"height": 60, "width": 60},
    ],
)
def test_same_rejections_as_jax(kw):
    def outcome(cls, **k):
        try:
            cls(**k)
        except ValueError as e:
            return type(e)
        return None

    jkw = dict(kw)
    if "use_kernel" in jkw:
        jkw["use_pallas"] = jkw.pop("use_kernel")
    assert outcome(RenderConfig, **kw) == outcome(JaxConfig, **jkw)
