"""serve/ — microbatched scoring of a trained StreamSVM bank (BankServer)."""
from .bank_server import BankServer, ScoreRequest, ServerStats

__all__ = ["BankServer", "ScoreRequest", "ServerStats"]
