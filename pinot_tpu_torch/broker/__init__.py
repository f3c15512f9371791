from .broker import (DEFAULT_TIMEOUT_MS, Broker, Connection,  # noqa: F401
                     QueryTimeoutError, connect)
from .quota import QuotaExceededError  # noqa: F401
