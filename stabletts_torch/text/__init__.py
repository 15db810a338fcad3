"""Host-side text frontend: symbol table, sequence conversion, intersperse.

(reference: text/__init__.py:33-42, datas/dataset.py:10-17)
"""

from __future__ import annotations

from typing import List, Sequence

from stabletts_torch.text.symbols import symbols, _symbol_to_id, _id_to_symbol, SPACE_ID  # noqa: F401


def cleaned_text_to_sequence(cleaned_text: Sequence[str]) -> List[int]:
    """Phoneme symbol list -> ID list; unknown symbols are silently dropped
    (reference: text/__init__.py:33-42)."""
    return [_symbol_to_id[s] for s in cleaned_text if s in _symbol_to_id]


def sequence_to_text(sequence: Sequence[int]) -> str:
    return "".join(_id_to_symbol[i] for i in sequence if i in _id_to_symbol)


def intersperse(lst: Sequence[int], item: int = 0) -> List[int]:
    """Insert a blank token between every pair of tokens and at both ends
    (reference: datas/dataset.py:10-17)."""
    result = [item] * (len(lst) * 2 + 1)
    result[1::2] = list(lst)
    return result
