from .beam import beam_search
from .predictor import Generator, decode_route, predictions_from_beams

__all__ = ["beam_search", "Generator", "decode_route",
           "predictions_from_beams"]
