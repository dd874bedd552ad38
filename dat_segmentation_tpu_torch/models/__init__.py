from .builder import build_model
from .dat import DAT, TransformerStage
from .deformable_attention import DeformableAttention
from .heads import ClsHead, ConvBNReLU, FPNHead, FPNNeck
from .segmentor import DatClassifier, EncoderDecoder
