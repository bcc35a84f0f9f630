from .filter_pack import filter_pack_words
from .ops import filter_pack
from .ref import filter_pack_ref
