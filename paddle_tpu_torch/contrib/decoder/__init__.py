from . import beam_search_decoder  # noqa: F401
from .beam_search_decoder import (BeamSearchDecoder, InitState,  # noqa: F401
                                  StateCell, TrainingDecoder)
