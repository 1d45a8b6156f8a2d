"""Tensor ops of the port: conv cell, DCNv2, stem, strided conv, pooling,
decode, NMS.

Importing the package registers the ``ppyolo`` operator library
(``ppyolo::dcn_fwd``, ``ppyolo::fused_stem``, ``ppyolo::nms_keep``,
``ppyolo::quantized_conv2d``), which a serving artifact
(``eval/export.py``) needs before it loads."""
from . import conv_int8, deform_conv_cuda, matrix_nms, stem  # noqa: F401  (the ppyolo:: operators)
