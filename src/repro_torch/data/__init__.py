from repro_torch.data.loader import DataIterator
from repro_torch.data.synthetic import (induction_heads, make_markov_lm,
                                        selective_copying)

__all__ = ["DataIterator", "make_markov_lm", "selective_copying", "induction_heads"]
