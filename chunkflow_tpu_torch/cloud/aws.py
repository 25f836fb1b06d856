"""AWS request signing (Signature Version 4), credentials, region and
endpoints, as the AWS SDKs resolve them, with the standard library only.

* :func:`sign` adds ``x-amz-date``, ``x-amz-content-sha256`` (S3),
  ``x-amz-security-token`` (a session) and ``Authorization`` to a
  request; :func:`verify` checks such a request (the local fakes use it);
* :class:`CredentialChain`: ``AWS_ACCESS_KEY_ID`` /
  ``AWS_SECRET_ACCESS_KEY`` / ``AWS_SESSION_TOKEN``, then the shared
  credentials file (``AWS_SHARED_CREDENTIALS_FILE``, else
  ``~/.aws/credentials``; profile ``AWS_PROFILE``, else ``default``),
  then the instance metadata service (IMDSv2: a token ``PUT``, then the
  role's credentials, each with a 1 s connect timeout;
  ``AWS_EC2_METADATA_SERVICE_ENDPOINT``, off under
  ``AWS_EC2_METADATA_DISABLED=true``), else unsigned requests;
* :func:`region`: ``AWS_REGION``, ``AWS_DEFAULT_REGION``, the profile's
  ``region`` in ``~/.aws/config`` (``AWS_CONFIG_FILE``), else
  ``us-east-1``;
* :func:`endpoint`: ``AWS_ENDPOINT_URL_<SERVICE>``, then
  ``AWS_ENDPOINT_URL``, else None (the service's own host).
"""
from __future__ import annotations

import configparser
import datetime
import hashlib
import hmac
import http.client
import json
import os
import threading
import time
import urllib.parse
from typing import Dict, Mapping, NamedTuple, Optional

__all__ = ["Credentials", "sign", "verify", "CredentialChain", "region",
           "endpoint", "sha256_hex", "UNSIGNED_PAYLOAD"]

ALGORITHM = "AWS4-HMAC-SHA256"
UNSIGNED_PAYLOAD = "UNSIGNED-PAYLOAD"
IMDS_ENDPOINT = "http://169.254.169.254"


class Credentials(NamedTuple):
    access_key: str
    secret_key: str
    token: Optional[str] = None
    expires: Optional[float] = None  # epoch seconds; None: never


def sha256_hex(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _quote(text: str) -> str:
    return urllib.parse.quote(text, safe="-_.~")


def _canonical_query(query: str) -> str:
    pairs = urllib.parse.parse_qsl(query, keep_blank_values=True)
    return "&".join(f"{_quote(k)}={_quote(v)}" for k, v in sorted(
        (k, v) for k, v in pairs))


def _canonical_headers(headers: Mapping[str, str], names) -> str:
    lowered = {k.lower(): " ".join(str(v).strip().split())
               for k, v in headers.items()}
    return "".join(f"{n}:{lowered[n]}\n" for n in names)


def _signing_key(secret: str, date: str, region_name: str,
                 service: str) -> bytes:
    key = f"AWS4{secret}".encode()
    for part in (date, region_name, service, "aws4_request"):
        key = hmac.new(key, part.encode(), hashlib.sha256).digest()
    return key


def _signature(method: str, path: str, query: str,
               headers: Mapping[str, str], signed: list, payload_hash: str,
               secret: str, amz_date: str, scope: str) -> str:
    canonical = "\n".join([method, path or "/", _canonical_query(query),
                           _canonical_headers(headers, signed),
                           ";".join(signed), payload_hash])
    to_sign = "\n".join([ALGORITHM, amz_date, scope,
                         sha256_hex(canonical.encode())])
    date, region_name, service, _ = scope.split("/")
    return hmac.new(_signing_key(secret, date, region_name, service),
                    to_sign.encode(), hashlib.sha256).hexdigest()


def sign(method: str, url: str, headers: Dict[str, str], body: bytes,
         creds: Credentials, region_name: str, service: str,
         now: Optional[float] = None) -> Dict[str, str]:
    """``headers`` with the SigV4 headers of this request added. S3 also
    signs ``x-amz-content-sha256``; the path is signed as it is sent
    (already percent-encoded)."""
    parts = urllib.parse.urlsplit(url)
    stamp = datetime.datetime.fromtimestamp(
        time.time() if now is None else now, tz=datetime.timezone.utc)
    amz_date = stamp.strftime("%Y%m%dT%H%M%SZ")
    out = {k: v for k, v in headers.items()
           if k.lower() != "authorization"}
    out.setdefault("Host", parts.netloc)
    out["x-amz-date"] = amz_date
    payload_hash = sha256_hex(body)
    if service == "s3":
        out["x-amz-content-sha256"] = payload_hash
    if creds.token:
        out["x-amz-security-token"] = creds.token
    signed = sorted(k.lower() for k in out)
    scope = f"{amz_date[:8]}/{region_name}/{service}/aws4_request"
    sig = _signature(method, parts.path, parts.query, out, signed,
                     payload_hash, creds.secret_key, amz_date, scope)
    out["Authorization"] = (f"{ALGORITHM} Credential={creds.access_key}/"
                            f"{scope}, SignedHeaders={';'.join(signed)}, "
                            f"Signature={sig}")
    return out


def verify(method: str, target: str, headers: Mapping[str, str],
           body: bytes, secrets: Mapping[str, str]) -> Optional[str]:
    """None when the request carries a valid SigV4 signature by a key of
    ``secrets`` (access key -> secret), else why not. ``target`` is the
    request line's path and query, as sent."""
    lowered = {k.lower(): v for k, v in headers.items()}
    auth = lowered.get("authorization", "")
    if not auth.startswith(ALGORITHM + " "):
        return "no SigV4 Authorization header"
    fields = {}
    for item in auth[len(ALGORITHM) + 1:].split(","):
        key, _, value = item.strip().partition("=")
        fields[key] = value
    try:
        access_key, scope = fields["Credential"].split("/", 1)
        signed = fields["SignedHeaders"].split(";")
        given = fields["Signature"]
    except (KeyError, ValueError):
        return "malformed Authorization header"
    if access_key not in secrets:
        return f"unknown access key {access_key}"
    if "host" not in signed or any(n not in lowered for n in signed):
        return "a signed header is missing"
    amz_date = lowered.get("x-amz-date", "")
    if amz_date[:8] != scope.split("/")[0]:
        return "x-amz-date is not the scope's date"
    payload_hash = lowered.get("x-amz-content-sha256") or sha256_hex(body)
    if payload_hash != UNSIGNED_PAYLOAD and payload_hash != sha256_hex(body):
        return "x-amz-content-sha256 is not the body's"
    path, _, query = target.partition("?")
    want = _signature(method, path, query, lowered, signed, payload_hash,
                      secrets[access_key], amz_date, scope)
    if not hmac.compare_digest(want, given):
        return "SignatureDoesNotMatch"
    return None


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------
def _home_file(env_name: str, default: str) -> str:
    return os.environ.get(env_name) or os.path.join(
        os.path.expanduser("~"), ".aws", default)


def _profile() -> str:
    return os.environ.get("AWS_PROFILE") or "default"


def region() -> str:
    for name in ("AWS_REGION", "AWS_DEFAULT_REGION"):
        if os.environ.get(name):
            return os.environ[name]
    config = configparser.ConfigParser()
    config.read(_home_file("AWS_CONFIG_FILE", "config"))
    profile = _profile()
    section = profile if profile == "default" else f"profile {profile}"
    if config.has_option(section, "region"):
        return config.get(section, "region")
    return "us-east-1"


def endpoint(service: str) -> Optional[str]:
    """The endpoint override of ``service`` (``s3``, ``sqs``), or None."""
    value = (os.environ.get(f"AWS_ENDPOINT_URL_{service.upper()}")
             or os.environ.get("AWS_ENDPOINT_URL"))
    return value.rstrip("/") if value else None


class CredentialChain:
    """The SDKs' credential chain, resolved at first use and refreshed 60 s
    before expiring credentials (the metadata service's) expire."""

    def __init__(self):
        from chunkflow_tpu_torch.cloud.http import HTTPClient

        self._http = HTTPClient(counter_prefix="auth/http", max_retries=0)
        self._lock = threading.Lock()
        self._creds: Optional[Credentials] = None
        self._resolved = False

    def get(self) -> Optional[Credentials]:
        """The credentials to sign with, or None: send unsigned."""
        with self._lock:
            creds = self._creds
            stale = (creds is not None and creds.expires is not None
                     and time.time() >= creds.expires - 60)
            if not self._resolved or stale:
                self._creds = self._resolve()
                self._resolved = True
            return self._creds

    def _resolve(self) -> Optional[Credentials]:
        env = os.environ
        if env.get("AWS_ACCESS_KEY_ID") and env.get("AWS_SECRET_ACCESS_KEY"):
            return Credentials(env["AWS_ACCESS_KEY_ID"],
                               env["AWS_SECRET_ACCESS_KEY"],
                               env.get("AWS_SESSION_TOKEN") or None)
        shared = configparser.ConfigParser()
        shared.read(_home_file("AWS_SHARED_CREDENTIALS_FILE", "credentials"))
        profile = _profile()
        if shared.has_option(profile, "aws_access_key_id"):
            return Credentials(
                shared.get(profile, "aws_access_key_id"),
                shared.get(profile, "aws_secret_access_key"),
                shared.get(profile, "aws_session_token", fallback=None))
        if env.get("AWS_EC2_METADATA_DISABLED", "").lower() == "true":
            return None
        return self._from_imds()

    def _from_imds(self) -> Optional[Credentials]:
        base = (os.environ.get("AWS_EC2_METADATA_SERVICE_ENDPOINT")
                or IMDS_ENDPOINT).rstrip("/")
        probe = dict(connect_timeout=1.0, max_retries=0)
        try:
            token = self._http.request(
                "PUT", f"{base}/latest/api/token",
                headers={"X-aws-ec2-metadata-token-ttl-seconds": "21600"},
                **probe)
        except (OSError, http.client.HTTPException):
            return None  # no metadata service: unsigned requests
        if token.status != 200:
            return None
        auth = {"X-aws-ec2-metadata-token": token.body.decode()}
        path = f"{base}/latest/meta-data/iam/security-credentials/"
        roles = self._http.request("GET", path, headers=auth, **probe)
        if roles.status != 200 or not roles.body.strip():
            return None
        role = roles.body.decode().split()[0]
        got = self._http.request("GET", path + role, headers=auth, **probe)
        if got.status != 200:
            raise IOError(f"the instance metadata service answered "
                          f"{got.status} for role {role}")
        doc = json.loads(got.body)
        expires = None
        if doc.get("Expiration"):
            expires = datetime.datetime.strptime(
                doc["Expiration"], "%Y-%m-%dT%H:%M:%SZ").replace(
                tzinfo=datetime.timezone.utc).timestamp()
        return Credentials(doc["AccessKeyId"], doc["SecretAccessKey"],
                           doc.get("Token"), expires)
