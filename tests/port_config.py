"""The port's own config fields, which the JAX package's dataclasses lack
(the neuralangelo head's), and ``jax_view``: a port config as ``asdict``
gives it without them, to compare with a JAX config.  The fields follow
JAX's in each dataclass, and their defaults leave a JAX configuration as
it is (tests/test_torch_boundary.py holds both)."""

import dataclasses

PORT_FIELDS = {
    "MLPConfig": ("head", "sdf_width", "rgb_width"),
    "RenderConfig": ("neus_fine_samples", "neus_rounds"),
    "TrainConfig": ("warmup_steps", "c2f_init_levels", "c2f_every"),
}
SECTION_CLASSES = {"hash": "HashConfig", "dir_enc": "PosEncConfig",
                   "mlp": "MLPConfig", "render": "RenderConfig",
                   "train": "TrainConfig"}


def jax_part(name: str, d: dict) -> dict:
    """``asdict`` of a port config of class ``name`` without the port's own
    fields."""
    if name == "PipelineConfig":
        return {k: jax_part(SECTION_CLASSES[k], v) for k, v in d.items()}
    return {k: v for k, v in d.items() if k not in PORT_FIELDS.get(name, ())}


def jax_view(cfg) -> dict:
    """A port config's ``asdict`` as the JAX package's config of the same
    values gives it."""
    return jax_part(type(cfg).__name__, dataclasses.asdict(cfg))
