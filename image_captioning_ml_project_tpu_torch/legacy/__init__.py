from .model import ShowAttendTell, LegacyEncoder, LegacyDecoder
from .train import LegacyTrainer, masked_caption_ce
from .validate import validate, visualize_attention, strip_specials
from .demo import generate_captions
from .process_data import build_vocab, resize_images, resize_image
