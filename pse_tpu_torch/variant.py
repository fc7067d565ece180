"""``pse_tpu_torch.variant.shear_variant``: strain variant for box tilting,
mirroring PSEv1/variant.py:15-32 (VariantShearFunction wrapper)."""

from .shear import ShearVariant, shear_variant

__all__ = ["ShearVariant", "shear_variant"]
