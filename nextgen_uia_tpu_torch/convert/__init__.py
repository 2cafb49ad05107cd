"""Torch checkpoint -> flat ``.npz`` converters (counterpart of
nextgen_uia_tpu/convert): ``python -m nextgen_uia_tpu_torch.convert <kind>
src dst``."""
