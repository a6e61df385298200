"""keras.preprocessing — sequence/text utilities.

The reference re-exports ``keras_preprocessing`` wholesale
(python/flexflow/keras/preprocessing/{sequence,text}.py); this environment
has no such dependency, so the pieces the workloads use (pad_sequences,
Tokenizer and friends for the reuters MLP) are implemented natively with
the same call signatures.
"""

from . import image, sequence, text
from .sequence import pad_sequences
from .text import Tokenizer, one_hot, text_to_word_sequence
