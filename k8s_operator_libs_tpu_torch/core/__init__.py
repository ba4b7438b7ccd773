"""The cluster client boundary: the client interface and its errors
(``client.py``), the object model (``objects.py``) and its wire JSON
(``serde.py``), and the live apiserver client (``liveclient.py``)."""

from .client import (ApiError, Client, ClientEventRecorder, ConflictError,
                     ExpiredError, InvalidError, NotFoundError,
                     ServerError, TooManyRequestsError, WatchError)

__all__ = ["ApiError", "Client", "ClientEventRecorder", "ConflictError",
           "ExpiredError", "InvalidError", "NotFoundError", "ServerError",
           "TooManyRequestsError", "WatchError"]
