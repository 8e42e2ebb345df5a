from .beam import beam_search
from .predictor import Generator, predictions_from_beams

__all__ = ["beam_search", "Generator", "predictions_from_beams"]
