"""Google credentials for the GCS client: the chain tensorstore follows.

1. ``GOOGLE_APPLICATION_CREDENTIALS``, then
   ``~/.config/gcloud/application_default_credentials.json``
   (``CLOUDSDK_CONFIG`` moves the directory). Each file is a
   ``service_account`` (an RS256-signed JWT assertion POSTed to its
   ``token_uri``) or an ``authorized_user`` (its refresh token POSTed to
   its token endpoint);
2. the GCE metadata server (``Metadata-Flavor: Google``; host
   ``GCE_METADATA_HOST``, else ``metadata.google.internal``), probed once
   with a 1 s connect timeout;
3. else no ``Authorization`` header.

Tokens are cached until 60 s before they expire. RS256 is computed here,
in pure Python: a small DER reader for PKCS#8 and PKCS#1 keys,
EMSA-PKCS1-v1_5 and ``pow(m, d, n)``, since neither machine the port
runs on may have a crypto package.
"""
from __future__ import annotations

import base64
import hashlib
import http.client
import json
import os
import threading
import time
import urllib.parse
from typing import NamedTuple, Optional, Tuple

__all__ = ["RSAKey", "load_private_key", "rs256_sign", "rs256_verify",
           "make_jwt", "decode_jwt", "GoogleCredentials", "SCOPE",
           "DEFAULT_TOKEN_URI"]

SCOPE = "https://www.googleapis.com/auth/devstorage.read_write"
DEFAULT_TOKEN_URI = "https://oauth2.googleapis.com/token"
METADATA_HOST = "metadata.google.internal"
METADATA_TOKEN_PATH = ("/computeMetadata/v1/instance/service-accounts/"
                       "default/token")
# DER of the SHA-256 AlgorithmIdentifier in a PKCS#1 v1.5 DigestInfo
_SHA256_DIGEST_INFO = bytes.fromhex("3031300d060960864801650304020105000420")
_RSA_OID = bytes.fromhex("2a864886f70d010101")


# ---------------------------------------------------------------------------
# RSA keys and RS256
# ---------------------------------------------------------------------------
class RSAKey(NamedTuple):
    n: int
    e: int
    d: Optional[int] = None  # None: a public key


def _der(data: bytes, pos: int) -> Tuple[int, bytes, int]:
    """(tag, value, next position) of the DER element at ``pos``."""
    tag = data[pos]
    length = data[pos + 1]
    pos += 2
    if length & 0x80:
        count = length & 0x7F
        length = int.from_bytes(data[pos:pos + count], "big")
        pos += count
    if pos + length > len(data):
        raise ValueError("truncated DER element")
    return tag, data[pos:pos + length], pos + length


def _der_items(data: bytes):
    pos = 0
    while pos < len(data):
        tag, value, pos = _der(data, pos)
        yield tag, value


def _pkcs1(der: bytes) -> RSAKey:
    tag, body, _ = _der(der, 0)
    ints = [int.from_bytes(v, "big") for t, v in _der_items(body)
            if t == 0x02]
    if tag != 0x30 or len(ints) < 4:
        raise ValueError("not a PKCS#1 RSA private key")
    return RSAKey(n=ints[1], e=ints[2], d=ints[3])


def load_private_key(pem: str) -> RSAKey:
    """An RSA private key from PEM: PKCS#8 (``PRIVATE KEY``, as service
    account files hold it) or PKCS#1 (``RSA PRIVATE KEY``)."""
    lines = [ln.strip() for ln in pem.strip().splitlines()]
    if not lines or not lines[0].startswith("-----BEGIN "):
        raise ValueError("not a PEM key")
    label = lines[0][len("-----BEGIN "):].rstrip("-")
    der = base64.b64decode("".join(ln for ln in lines
                                   if not ln.startswith("-----")))
    if label == "RSA PRIVATE KEY":
        return _pkcs1(der)
    if label != "PRIVATE KEY":
        raise ValueError(f"unsupported PEM block {label!r}")
    tag, body, _ = _der(der, 0)
    items = list(_der_items(body))
    if tag != 0x30 or len(items) < 3 or items[1][0] != 0x30 \
            or _RSA_OID not in items[1][1] or items[2][0] != 0x04:
        raise ValueError("not a PKCS#8 RSA private key")
    return _pkcs1(items[2][1])


def _emsa_pkcs1_v15(message: bytes, size: int) -> bytes:
    digest = _SHA256_DIGEST_INFO + hashlib.sha256(message).digest()
    if size < len(digest) + 11:
        raise ValueError("RSA key too short for SHA-256")
    return b"\x00\x01" + b"\xff" * (size - len(digest) - 3) + b"\x00" \
        + digest


def rs256_sign(key: RSAKey, message: bytes) -> bytes:
    size = (key.n.bit_length() + 7) // 8
    m = int.from_bytes(_emsa_pkcs1_v15(message, size), "big")
    return pow(m, key.d, key.n).to_bytes(size, "big")


def rs256_verify(key: RSAKey, message: bytes, signature: bytes) -> bool:
    size = (key.n.bit_length() + 7) // 8
    if len(signature) != size:
        return False
    m = pow(int.from_bytes(signature, "big"), key.e, key.n)
    return m.to_bytes(size, "big") == _emsa_pkcs1_v15(message, size)


def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _unb64url(text: str) -> bytes:
    return base64.urlsafe_b64decode(text + "=" * (-len(text) % 4))


def make_jwt(key: RSAKey, claims: dict, key_id: Optional[str] = None) -> str:
    header = {"alg": "RS256", "typ": "JWT"}
    if key_id:
        header["kid"] = key_id
    signing_input = (_b64url(json.dumps(header).encode()) + "." +
                     _b64url(json.dumps(claims).encode()))
    return signing_input + "." + _b64url(rs256_sign(
        key, signing_input.encode()))


def decode_jwt(token: str, key: RSAKey) -> Optional[dict]:
    """The claims of an RS256 JWT signed by ``key``, or None."""
    try:
        head, claims, sig = token.split(".")
        header = json.loads(_unb64url(head))
        if header.get("alg") != "RS256" or not rs256_verify(
                key, f"{head}.{claims}".encode(), _unb64url(sig)):
            return None
        return json.loads(_unb64url(claims))
    except (ValueError, TypeError):
        return None


# ---------------------------------------------------------------------------
# the credential chain
# ---------------------------------------------------------------------------
def _adc_path() -> Optional[str]:
    """The credentials file of the chain's first step, or None."""
    explicit = os.environ.get("GOOGLE_APPLICATION_CREDENTIALS")
    if explicit:
        if not os.path.isfile(explicit):
            raise FileNotFoundError(
                f"GOOGLE_APPLICATION_CREDENTIALS names {explicit}, which "
                f"does not exist")
        return explicit
    config = os.environ.get("CLOUDSDK_CONFIG") or os.path.join(
        os.path.expanduser("~"), ".config", "gcloud")
    path = os.path.join(config, "application_default_credentials.json")
    return path if os.path.isfile(path) else None


class GoogleCredentials:
    """Bearer tokens for ``storage.googleapis.com`` (or none)."""

    def __init__(self, clock=time.time):
        from chunkflow_tpu_torch.cloud.http import HTTPClient

        self._http = HTTPClient(counter_prefix="auth/http")
        self._clock = clock
        self._lock = threading.Lock()
        self._source: Optional[str] = None  # file | metadata | none
        self._file: Optional[dict] = None
        self._token: Optional[str] = None
        self._expires = 0.0
        self.refreshes = 0

    @property
    def source(self) -> str:
        with self._lock:
            self._pick_source()
            return self._source

    def _pick_source(self) -> None:
        if self._source is not None:
            return
        path = _adc_path()
        if path is not None:
            with open(path) as f:
                self._file = json.load(f)
            kind = self._file.get("type")
            if kind not in ("service_account", "authorized_user"):
                raise ValueError(f"unsupported credentials type {kind!r} "
                                 f"in {path}")
            self._source = "file"
        elif self._metadata_reachable():
            self._source = "metadata"
        else:
            self._source = "none"

    def _metadata_host(self) -> str:
        return os.environ.get("GCE_METADATA_HOST") or METADATA_HOST

    def _metadata_reachable(self) -> bool:
        try:
            got = self._http.request(
                "GET", f"http://{self._metadata_host()}/",
                headers={"Metadata-Flavor": "Google"},
                connect_timeout=1.0, max_retries=0)
        except (OSError, http.client.HTTPException):
            return False
        return got.headers.get("metadata-flavor") == "Google"

    def authorization(self) -> Optional[str]:
        """``Bearer <token>``, refreshed 60 s before it expires; None
        without credentials."""
        with self._lock:
            self._pick_source()
            if self._source == "none":
                return None
            if self._token is None or self._clock() >= self._expires - 60:
                self._token, lifetime = self._fetch()
                self._expires = self._clock() + lifetime
                self.refreshes += 1
            return f"Bearer {self._token}"

    def _fetch(self) -> Tuple[str, float]:
        if self._source == "metadata":
            got = self._http.request(
                "GET", f"http://{self._metadata_host()}"
                       f"{METADATA_TOKEN_PATH}",
                headers={"Metadata-Flavor": "Google"})
            return self._token_answer(got, "the metadata server")
        info = self._file
        if info["type"] == "service_account":
            uri = info.get("token_uri") or DEFAULT_TOKEN_URI
            now = int(self._clock())
            assertion = make_jwt(
                load_private_key(info["private_key"]),
                {"iss": info["client_email"], "scope": SCOPE, "aud": uri,
                 "iat": now, "exp": now + 3600},
                key_id=info.get("private_key_id"))
            form = {"grant_type":
                    "urn:ietf:params:oauth:grant-type:jwt-bearer",
                    "assertion": assertion}
        else:
            uri = info.get("token_uri") or DEFAULT_TOKEN_URI
            form = {"grant_type": "refresh_token",
                    "client_id": info["client_id"],
                    "client_secret": info["client_secret"],
                    "refresh_token": info["refresh_token"]}
        got = self._http.request(
            "POST", uri, body=urllib.parse.urlencode(form).encode(),
            headers={"Content-Type": "application/x-www-form-urlencoded"})
        return self._token_answer(got, uri)

    @staticmethod
    def _token_answer(got, where: str) -> Tuple[str, float]:
        if got.status != 200:
            raise IOError(f"{where} answered {got.status} to a token "
                          f"request: {got.body[:300]!r}")
        doc = json.loads(got.body)
        return doc["access_token"], float(doc.get("expires_in", 3600))
