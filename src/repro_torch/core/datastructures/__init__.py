"""The paper's benchmark data structures, parameterized over an SMR scheme."""

from .crturn_queue import CRTurnQueue
from .harris_list import HarrisMichaelList, ListNode
from .kogan_petrank_queue import KPQueue
from .michael_hashmap import MichaelHashMap
from .natarajan_bst import BSTNode, NatarajanBST
from .treiber_stack import StackNode, TreiberStack

__all__ = [
    "TreiberStack",
    "StackNode",
    "HarrisMichaelList",
    "ListNode",
    "MichaelHashMap",
    "NatarajanBST",
    "BSTNode",
    "KPQueue",
    "CRTurnQueue",
]
