"""Challenge-specific evaluation and submission tooling (numpy and scipy,
no torch): the PROMISE12 volumetric metrics and MHD submission writer, the
ultrasound-nerve run-length encoding and incoherent-image filter. Copies
of `senas_tpu/challenge/`."""

from senas_torch.challenge.nerve import (  # noqa: F401
    filter_incoherent_images,
    hard_dice,
    rle_decoding,
    rle_encoding,
    write_rle_submission,
)
from senas_torch.challenge.promise12 import (  # noqa: F401
    iter_case_volumes,
    numpy_dice,
    predict_test,
    rel_abs_vol_diff,
    resize_slices_nearest,
    surface_distances,
    volumetric_metrics,
)
