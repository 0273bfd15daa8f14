# The paper's baselines (§7.1): JM, join-based, and TM, tree-based.  Plain
# numpy on the host, never on the card.
from .jm import JMBudgetExceeded, jm_match
from .tm import TMTimeout, tm_match

__all__ = ["jm_match", "tm_match", "JMBudgetExceeded", "TMTimeout"]
