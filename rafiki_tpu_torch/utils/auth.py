"""Auth: HS256 JWTs and password hashing, stdlib only.

The port's own copy of ``rafiki_tpu/utils/auth.py``, unchanged in what
it computes: a standard HS256 JWT (header.payload.signature, hmac +
sha256 + base64url) and PBKDF2-HMAC-SHA256 password hashes stored as
``pbkdf2$<iterations>$<salt_hex>$<hash_hex>``. Under the same secret a
token or a hash made by either package is accepted by the other.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import os
import time
from typing import Any, Dict, List, Optional

from rafiki_tpu_torch.constants import UserType

_PBKDF2_ITERATIONS = 100_000


class AuthError(Exception):
    """Raised on bad credentials, bad tokens, or insufficient role."""


# -- password hashing --------------------------------------------------------


def hash_password(password: str) -> str:
    salt = os.urandom(16)
    digest = hashlib.pbkdf2_hmac(
        "sha256", password.encode(), salt, _PBKDF2_ITERATIONS)
    return f"pbkdf2${_PBKDF2_ITERATIONS}${salt.hex()}${digest.hex()}"


def verify_password(password: str, stored: str) -> bool:
    try:
        scheme, iters, salt_hex, hash_hex = stored.split("$")
        if scheme != "pbkdf2":
            return False
        digest = hashlib.pbkdf2_hmac(
            "sha256", password.encode(), bytes.fromhex(salt_hex), int(iters))
        return hmac.compare_digest(digest.hex(), hash_hex)
    except (ValueError, AttributeError):
        return False


# -- JWT (HS256) -------------------------------------------------------------


def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _unb64url(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


def generate_token(payload: Dict[str, Any], secret: str,
                   ttl_s: Optional[float] = None) -> str:
    """Standard JWT: header.payload.signature, HS256."""
    header = {"alg": "HS256", "typ": "JWT"}
    body = dict(payload)
    if ttl_s is not None:
        body["exp"] = time.time() + ttl_s
    signing_input = f"{_b64url(json.dumps(header).encode())}.{_b64url(json.dumps(body).encode())}"
    sig = hmac.new(secret.encode(), signing_input.encode(), hashlib.sha256).digest()
    return f"{signing_input}.{_b64url(sig)}"


def decode_token(token: str, secret: str) -> Dict[str, Any]:
    try:
        signing_input, sig_b64 = token.rsplit(".", 1)
        header_b64, payload_b64 = signing_input.split(".")
        header = json.loads(_unb64url(header_b64))
        sig = _unb64url(sig_b64)
    except (ValueError, json.JSONDecodeError):
        raise AuthError("Malformed token")
    if header.get("alg") != "HS256":  # no alg-confusion: HS256 only
        raise AuthError("Unsupported token algorithm")
    expected = hmac.new(secret.encode(), signing_input.encode(), hashlib.sha256).digest()
    if not hmac.compare_digest(sig, expected):
        raise AuthError("Invalid token signature")
    try:
        payload = json.loads(_unb64url(payload_b64))
    except (ValueError, json.JSONDecodeError):
        raise AuthError("Malformed token payload")
    exp = payload.get("exp")
    if exp is not None and time.time() > float(exp):
        raise AuthError("Token expired")
    return payload


# -- role checks -------------------------------------------------------------


def check_user_type(user_type: str, allowed: List[str]) -> None:
    """Raise AuthError unless ``user_type`` is one of ``allowed`` or an
    admin role (SUPERADMIN/ADMIN can do anything a developer can; the
    two developer roles are otherwise disjoint)."""
    if user_type in allowed:
        return
    if user_type in (UserType.SUPERADMIN.value, UserType.ADMIN.value):
        return
    raise AuthError(f"User type {user_type} not permitted (need one of {allowed})")
