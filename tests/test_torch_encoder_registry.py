"""The port's encoder registry (`senas_torch/models/encoders.py`) against
senas_tpu's: the pyramid channels (`encoder_out_channels`, read off a
forward on the meta device) of every name of the SE-Net / Xception /
Inception / DPN, MobileNetV3 and ResNeSt registries (the VGG / DenseNet /
MobileNetV2 / EfficientNet names: tests/test_torch_encoders_extra.py; the
timm residual variants against senas_tpu's forward:
tests/test_torch_encoders_{timm2,sknet_gernet}.py), `get_encoder_names`,
the `tu-` aliases, the gated and unknown names. The timm residual
variants, which the port once refused, build as senas_tpu's do: the same
class and stated pyramid for each name and `tu-` alias."""

import pytest

from senas_torch.models import encoders as tenc
from senas_tpu.models import encoders as jenc
from senas_tpu.models.encoders_families import FAMILY_ENCODERS
from senas_tpu.models.encoders_mnv3 import MNV3_ENCODERS
from senas_tpu.models.encoders_resnest import RESNEST_ENCODERS
from senas_tpu.models.encoders_timm2 import TIMM2_ENCODERS

from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

TU_ALIASES = ["tu-resnet34", "tu-resnest14d", "tu-tf_efficientnet_lite0", "tu-efficientnet_b0",
              "tu-seresnet50", "tu-seresnext50_32x4d", "tu-mobilenetv2_100", "tu-vgg11_bn",
              "tu-dpn68", "tu-mobilenetv3_large_100", "tu-efficientnet-b3", "tu-xception",
              "tu-res2net50_48w_2s", "tu-regnetx_002", "tu-skresnet34", "tu-gernet_m"]
TIMM2_ALIASES = ["tu-res2net50_26w_4s", "tu-regnety_016", "tu-skresnet18", "tu-gernet_s",
                 "tu-res2next50"]


@pytest.mark.parametrize("name", sorted({**FAMILY_ENCODERS, **MNV3_ENCODERS,
                                         **RESNEST_ENCODERS}))
def test_encoder_out_channels_match(name):
    assert tenc.encoder_out_channels(name) == jenc.encoder_out_channels(name)


def test_the_port_builds_every_name_but_the_timm_residual_variants():
    """The timm residual variants included now: senas_tpu's names, in its
    order."""
    assert tenc.get_encoder_names() == jenc.get_encoder_names()
    assert set(TIMM2_ENCODERS) <= set(tenc.get_encoder_names())


@pytest.mark.parametrize("name", TU_ALIASES)
def test_tu_aliases_resolve_as_in_senas_tpu(name):
    resolved = jenc._resolve_tu_alias(name, jenc.get_encoder_names()) or name
    want = jenc.get_encoder(name)
    got = tenc.get_encoder(name, in_channels=3)
    assert type(got).__name__ == type(want).__name__, (name, resolved)
    assert tenc.encoder_out_channels(name) == jenc.encoder_out_channels(name)


@pytest.mark.parametrize("name", sorted(TIMM2_ENCODERS) + TIMM2_ALIASES)
def test_timm_residual_variants_name_the_next_slice(name):
    """The names that named the next slice (ROADMAP's M15c) before the port
    built them: senas_tpu's class and its stated pyramid (the module's
    `out_channels`; the forward's: `test_encoder_out_channels_match`)."""
    want = jenc.get_encoder(name)
    got = tenc.get_encoder(name, in_channels=3)
    assert type(got).__name__ == type(want).__name__
    assert tenc.encoder_out_channels(name) == tuple(want.out_channels)
    if name.startswith("tu-"):
        assert tenc.encoder_out_channels(name) == jenc.encoder_out_channels(name)


def test_gated_and_unknown_names_raise_key_errors():
    for name in ("tu-swin_base_patch4_window7_224", "tu-convnext_tiny"):
        with pytest.raises(KeyError, match="timm") as want:
            jenc.get_encoder(name)
        with pytest.raises(KeyError, match="timm") as got:
            tenc.get_encoder(name)
        assert str(got.value).split(";")[0] == str(want.value).split(";")[0]
    for name in ("vgg7", "efficientnet-b9", "dpn1"):
        with pytest.raises(KeyError, match=f"unknown encoder '{name}'"):
            tenc.get_encoder(name)
        with pytest.raises(KeyError, match=f"unknown encoder '{name}'"):
            jenc.get_encoder(name)


def test_a_dilated_encoder_of_an_undilatable_family_raises_for_every_name():
    for name in tenc.get_encoder_names():
        for os_ in (16, 8):
            try:
                jenc.get_encoder(name, output_stride=os_)
                want = None
            except ValueError as e:
                want = str(e)
            try:
                tenc.get_encoder(name, output_stride=os_, depth=1)
                got = None
            except ValueError as e:
                got = str(e)
            assert got == want, (name, os_)
