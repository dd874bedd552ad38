from .builder import build_backbone, build_model, build_model_from_config, register_head
from .dat import DAT, TransformerStage
from .deformable_attention import DeformableAttention
from .heads import ClsHead, ConvBNReLU, FCNHead, FPNHead, FPNNeck, UPerHead
from .segmentor import DatClassifier, EncoderDecoder
