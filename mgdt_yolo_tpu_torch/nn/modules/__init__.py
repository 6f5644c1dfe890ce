"""Building blocks of the port's graphs (NCHW modules), re-exported by name
as the JAX package's `nn/modules/__init__.py` re-exports its own; each name
is imported from its module at first use (`_lazy.lazy_exports`)."""
from ... import _lazy

_NAMES = {
    **dict.fromkeys(("C1", "C2", "C2f", "C3", "C3Ghost", "C3x", "C3TR", "IFM", "SPP", "SPPF",
                     "Bottleneck", "BottleneckCSP", "ConvNeXtV2_Block", "DyDCNv2", "GRN",
                     "GhostBottleneck", "HGBlock", "HGStem", "InjectionMultiSum_Auto_pool",
                     "MSPA_C2f", "Proto", "RepC3", "SPRModule", "SimFusion_3in",
                     "SimFusion_4in", "dfl_decode"), ".block"),
    **dict.fromkeys(("BN", "CBAM", "ChannelAttention", "Concat", "Conv", "Conv2",
                     "ConvTranspose", "DWConv", "DWConvTranspose2d", "Focus", "GhostConv",
                     "LightConv", "MaxPool2d", "RepConv", "RepVGGBlock", "SpatialAttention",
                     "Upsample", "ZeroPad2d", "autopad", "set_default_act"), ".conv"),
    **dict.fromkeys(("Classify", "Conv_GN", "Detect", "Pose", "Segment", "TaskDecomposition",
                     "TOODHead", "decode_detections"), ".head"),
}
__getattr__, __dir__, __all__ = _lazy.lazy_exports(__name__, _NAMES)
