"""Network registry.

Same keys as ``deepatlas_tpu.models``: ``get_network(name)`` returns a module
factory called with the reference's model settings, e.g.
``get_network("UNet_light")(in_channel=1, n_classes=5, bias=True, BN=True,
dtype=torch.bfloat16)`` or ``get_network("voxel_morph_cvpr")(max_disp=8)``.
"""
from __future__ import annotations

from functools import partial

import torch

from .convert import adam_from_optax, unet_from_flax, voxelmorph_from_flax
from .layers import (BatchNorm, ConvBlock, DeconvBlock, max_pool_3d,
                     use_spatial_axis)
from .unet import UNET_DECODERS, UNET_ENCODERS, UNet, UNetTemplate
from .voxelmorph import VoxelMorphCVPR2018

__all__ = ["adam_from_optax", "BatchNorm", "ConvBlock", "DeconvBlock",
           "UNet", "UNetLight", "UNetTemplate", "VoxelMorphCVPR2018",
           "get_available_networks", "get_network", "max_pool_3d",
           "network_dic", "resolve_model_settings", "unet_from_flax",
           "use_spatial_axis", "voxelmorph_from_flax"]

# the UNet_light channel plan
UNET_LIGHT_ENCODERS = ((8, 16), (16, 16, 32), (32, 32, 64), (64, 64, 64))
UNET_LIGHT_DECODERS = ((64, 64, 64), (64, 32, 32), (32, 16, 16))

UNetLight = partial(UNetTemplate,
                    encoders=UNET_LIGHT_ENCODERS,
                    decoders=UNET_LIGHT_DECODERS,
                    act="LeakyReLU")

network_dic = {
    "voxel_morph_cvpr": VoxelMorphCVPR2018,
    "UNet": UNet,
    "UNet_light": UNetLight,
}


def get_network(network_name: str):
    if network_name not in network_dic:
        raise KeyError(f'Network "{network_name}" is not available!\n '
                       f"Choose from: {get_available_networks()}")
    return network_dic[network_name]


def get_available_networks():
    return tuple(network_dic.keys())


def resolve_model_settings(settings: dict) -> dict:
    """Make JSON-borne model settings constructor-ready: the config
    snapshot stores ``dtype`` as a string ("bfloat16" / "float32"); convert
    it to the torch dtype the modules expect."""
    out = dict(settings)
    dt = out.get("dtype")
    if isinstance(dt, str):
        out["dtype"] = {"bfloat16": torch.bfloat16,
                        "float32": torch.float32}[dt]
    return out
