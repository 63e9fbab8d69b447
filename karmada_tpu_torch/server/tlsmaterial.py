"""Bearer-token material for the serving boundary (the part of the
reference's server/tlsmaterial.py that the daemons' --scrape-token-file
flag needs). The cluster CA and server certificates (`ensure_server_tls`,
over `auth/pki.py`) serve the control-plane daemon, which the port does
not have yet (ROADMAP queue A item 12)."""
from __future__ import annotations

import os
import secrets


def ensure_token(token_file: str) -> str:
    """Read the bearer token from token_file, generating one on first use."""
    if not os.path.exists(token_file):
        parent = os.path.dirname(os.path.abspath(token_file))
        os.makedirs(parent, exist_ok=True)
        fd = os.open(token_file, os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o600)
        with os.fdopen(fd, "w") as f:
            f.write(secrets.token_urlsafe(24))
    with open(token_file) as f:
        return f.read().strip()
