"""Dataset acquisition, verification and stats: the port's CLI, after
``fedml_tpu/data/acquire.py`` (the same catalog, manifest format and
verbs; the port imports nothing of the JAX package).

The reference ships per-dataset ``data/*/download_*.sh`` + ``stats.sh``
(reference data/README.md:1-28); this module is one command with three
verbs:

  python -m fedml_tpu_torch.data.acquire fetch  <dataset> [--data_dir ./data] [--dry_run]
  python -m fedml_tpu_torch.data.acquire verify <dataset> [--data_dir ./data]
  python -m fedml_tpu_torch.data.acquire stats  <dataset> [--data_dir ./data] [--clients N]

``fetch`` downloads the artifacts the reference's scripts fetch (URLs
lifted from those scripts) and records a sha256 manifest; ``--dry_run``
prints the downloads without touching the network. ``verify`` re-hashes
files against the recorded manifest. ``stats`` loads the dataset through
the port's registry (a seeded surrogate when the files are absent, like
every loader) and prints the reference stats.py-style per-client summary.
A manifest written by either package verifies under the other.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import urllib.error
import urllib.request

from fedml_tpu_torch.robustness.retry import RetryPolicy, call_with_retry

# artifact catalog: dataset -> list of (relative target path, url, unpack)
# URLs are the ones the reference's download scripts fetch. Google-Drive
# hosted LEAF archives need the confirm-token dance; fetch uses the direct
# uc?export=download URL which works for unrestricted files.
_GD = "https://docs.google.com/uc?export=download&id="
CATALOG: dict[str, list[tuple[str, str, str | None]]] = {
    "mnist": [
        # reference MNIST/data_loader downloads via torchvision; these are
        # the canonical IDX mirrors it resolves to
        ("MNIST/raw/train-images-idx3-ubyte.gz",
         "https://ossci-datasets.s3.amazonaws.com/mnist/train-images-idx3-ubyte.gz", None),
        ("MNIST/raw/train-labels-idx1-ubyte.gz",
         "https://ossci-datasets.s3.amazonaws.com/mnist/train-labels-idx1-ubyte.gz", None),
        ("MNIST/raw/t10k-images-idx3-ubyte.gz",
         "https://ossci-datasets.s3.amazonaws.com/mnist/t10k-images-idx3-ubyte.gz", None),
        ("MNIST/raw/t10k-labels-idx1-ubyte.gz",
         "https://ossci-datasets.s3.amazonaws.com/mnist/t10k-labels-idx1-ubyte.gz", None),
    ],
    "femnist": [
        ("fed_emnist.tar.bz2",
         "https://fedml.s3-us-west-1.amazonaws.com/fed_emnist.tar.bz2", "tar"),
    ],
    "fed_cifar100": [
        ("fed_cifar100.tar.bz2",
         "https://fedml.s3-us-west-1.amazonaws.com/fed_cifar100.tar.bz2", "tar"),
    ],
    "fed_shakespeare": [
        ("shakespeare.tar.bz2",
         "https://fedml.s3-us-west-1.amazonaws.com/shakespeare.tar.bz2", "tar"),
    ],
    "shakespeare": [
        ("shakespeare/train/all_data_niid_2_keep_0_train_8.json",
         _GD + "1mD6_4ju7n2WFAahMKDtozaGxUASaHAPH", None),
        ("shakespeare/test/all_data_niid_2_keep_0_test_8.json",
         _GD + "1GERQ9qEJjXk_0FXnw1JbjuGCI-zmmfsk", None),
    ],
    "stackoverflow_nwp": [
        ("stackoverflow.tar.bz2",
         "https://fedml.s3-us-west-1.amazonaws.com/stackoverflow.tar.bz2", "tar"),
        ("stackoverflow.word_count.tar.bz2",
         "https://fedml.s3-us-west-1.amazonaws.com/stackoverflow.word_count.tar.bz2", "tar"),
    ],
    "stackoverflow_lr": [
        ("stackoverflow.tar.bz2",
         "https://fedml.s3-us-west-1.amazonaws.com/stackoverflow.tar.bz2", "tar"),
        ("stackoverflow.tag_count.tar.bz2",
         "https://fedml.s3-us-west-1.amazonaws.com/stackoverflow.tag_count.tar.bz2", "tar"),
    ],
    "cifar10": [
        ("cifar-10-python.tar.gz",
         "https://www.cs.toronto.edu/~kriz/cifar-10-python.tar.gz", "tar"),
    ],
    "cifar100": [
        ("cifar-100-python.tar.gz",
         "https://www.cs.toronto.edu/~kriz/cifar-100-python.tar.gz", "tar"),
    ],
    "cinic10": [
        ("CINIC-10.tar.gz",
         "https://datashare.is.ed.ac.uk/bitstream/handle/10283/3192/CINIC-10.tar.gz", "tar"),
    ],
    "landmarks": [
        ("landmark/images.zip",
         "https://fedcv.s3-us-west-1.amazonaws.com/landmark/images.zip", "zip"),
        ("landmark/data_user_dict.zip",
         "https://fedcv.s3-us-west-1.amazonaws.com/landmark/data_user_dict.zip", "zip"),
    ],
    "edge_case_examples": [
        ("edge_case_examples.zip",
         "http://pages.cs.wisc.edu/~hongyiwang/edge_case_attack/edge_case_examples.zip",
         "zip"),
    ],
}

MANIFEST = "manifest.sha256.json"

# transient network failures (resets, timeouts, 5xx) get capped-backoff
# retries; permanent HTTP errors (404 and friends) fail immediately
DOWNLOAD_POLICY = RetryPolicy(max_attempts=4, base_delay=1.0, max_delay=30.0,
                              retryable=(OSError,))


def _download(url: str, dst: str, fetcher=None, policy: RetryPolicy | None = None,
              sleep=None, rng=None) -> None:
    """One artifact download with retry (fetcher/sleep/rng injectable for
    deterministic tests). HTTPError is an OSError subclass, so a plain
    retryable=(OSError,) would retry a 404 forever — client errors other
    than 429 are rewrapped as non-retryable RuntimeError instead."""
    fetch_one = urllib.request.urlretrieve if fetcher is None else fetcher

    def once():
        try:
            fetch_one(url, dst)  # noqa: S310 — catalog URLs only
        except urllib.error.HTTPError as e:
            if 400 <= e.code < 500 and e.code != 429:
                raise RuntimeError(
                    f"{url}: HTTP {e.code} {e.reason} — permanent, not "
                    "retrying") from e
            raise

    kwargs = {}
    if sleep is not None:
        kwargs["sleep"] = sleep
    if rng is not None:
        kwargs["rng"] = rng

    def on_retry(attempt, exc, delay):
        from fedml_tpu_torch import telemetry

        # status: the HTTP code when the server answered, else the failure
        # class name (ConnectionResetError, TimeoutError, ...)
        status = (str(exc.code) if isinstance(exc, urllib.error.HTTPError)
                  else type(exc).__name__)
        telemetry.emit("download_retry", attempt=attempt, status=status,
                       backoff_s=delay)
        print(f"  download failed ({exc}); retry {attempt} in {delay:.1f}s")

    call_with_retry(
        once,
        policy=policy or DOWNLOAD_POLICY,
        on_retry=on_retry,
        **kwargs,
    )


def _sha256(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def _manifest_path(data_dir: str, dataset: str) -> str:
    return os.path.join(data_dir, f"{dataset}.{MANIFEST}")


def _looks_like_html(path: str) -> bool:
    with open(path, "rb") as f:
        head = f.read(512).lstrip().lower()
    return head.startswith(b"<!doctype html") or head.startswith(b"<html")


def _gdrive_retry_url(html_path: str, url: str) -> str:
    """Build the real download URL out of the virus-scan interstitial.

    The modern interstitial is a GET form posting to
    drive.usercontent.google.com/download with hidden inputs (id, export,
    confirm, uuid, ...) — reconstruct exactly that request. Legacy pages
    instead carry a confirm=<token> in a link; fall back to appending it
    (or the modern accept-anyway value 't') to the original URL."""
    import re
    from html.parser import HTMLParser
    from urllib.parse import urlencode

    class _Form(HTMLParser):
        def __init__(self):
            super().__init__()
            self.action = None
            self.fields = {}

        def handle_starttag(self, tag, attrs):
            a = dict(attrs)
            if tag == "form" and self.action is None and a.get("action"):
                self.action = a["action"]
            elif tag == "input" and a.get("name") and "value" in a:
                self.fields[a["name"]] = a["value"] or ""

    with open(html_path, "rb") as f:
        html = f.read().decode("utf-8", "replace")
    form = _Form()
    form.feed(html)
    if form.action and form.fields:
        return form.action + "?" + urlencode(form.fields)
    m = re.search(r"confirm=([0-9A-Za-z_-]+)", html)
    return url + "&confirm=" + (m.group(1) if m else "t")


def fetch(dataset: str, data_dir: str, dry_run: bool = False,
          retries: int | None = None) -> int:
    """Download the dataset's artifacts and record their sha256 manifest.
    --dry_run prints what would run (the zero-egress-inspectable mode);
    --retries overrides the per-artifact retry budget (default 4 attempts
    with capped full-jitter backoff)."""
    entries = CATALOG[dataset]
    policy = (DOWNLOAD_POLICY if retries is None
              else RetryPolicy(max_attempts=max(1, retries),
                               base_delay=DOWNLOAD_POLICY.base_delay,
                               max_delay=DOWNLOAD_POLICY.max_delay,
                               retryable=DOWNLOAD_POLICY.retryable))
    manifest = {}
    for rel, url, unpack in entries:
        dst = os.path.join(data_dir, rel)
        print(f"fetch {url}\n  -> {dst}" + (f"  (then unpack: {unpack})" if unpack else ""))
        if dry_run:
            continue
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        if os.path.exists(dst):
            if _looks_like_html(dst):
                # leftover from a pre-guard run that saved an interstitial
                raise RuntimeError(
                    f"{dst} is an HTML page, not the artifact (a saved "
                    "download interstitial?) — delete it and re-run fetch")
            # the manifest will record THIS file's hash — make the trust
            # explicit so a stale/truncated leftover isn't silently blessed
            print(f"  exists ({os.path.getsize(dst)} bytes) — trusting the "
                  "local copy; delete it to force a re-download")
        else:
            # download to a temp name + atomic rename: an interrupted fetch
            # never leaves a partial file at dst that a re-run would skip
            # and bless into the manifest
            tmp = dst + ".part"
            _download(url, tmp, policy=policy)
            if _looks_like_html(tmp):
                # Google-Drive uc?export=download answers large files with a
                # virus-scan interstitial page; saving it would record the
                # HTML's hash and verify would pass on garbage
                if "docs.google.com" in url:
                    retry = _gdrive_retry_url(tmp, url)
                    print(f"  Drive interstitial detected — retrying {retry}")
                    _download(retry, tmp, policy=policy)
                if _looks_like_html(tmp):
                    os.remove(tmp)
                    hint = (
                        " The file may be rate-limited or need a signed-in "
                        "session: open the URL in a browser, download "
                        f"manually, place the file at {dst}, and re-run "
                        "fetch (it will trust and hash the local copy)."
                        if "docs.google.com" in url else "")
                    raise RuntimeError(
                        f"{url} returned an HTML page, not the artifact — "
                        f"refusing to record it in the manifest.{hint}")
            os.replace(tmp, dst)
        manifest[rel] = {"sha256": _sha256(dst), "bytes": os.path.getsize(dst)}
        if unpack == "tar":
            import tarfile

            with tarfile.open(dst) as tf:
                tf.extractall(os.path.dirname(dst), filter="data")
        elif unpack == "zip":
            import zipfile

            with zipfile.ZipFile(dst) as zf:
                zf.extractall(os.path.dirname(dst))
    if not dry_run:
        with open(_manifest_path(data_dir, dataset), "w") as f:
            json.dump(manifest, f, indent=2)
        print(f"manifest written: {_manifest_path(data_dir, dataset)}")
    return 0


def verify(dataset: str, data_dir: str) -> int:
    """Re-hash downloaded artifacts against the recorded manifest."""
    mpath = _manifest_path(data_dir, dataset)
    if not os.path.exists(mpath):
        print(f"no manifest at {mpath} — run `fetch {dataset}` first", file=sys.stderr)
        return 2
    with open(mpath) as f:
        manifest = json.load(f)
    rc = 0
    for rel, want in manifest.items():
        path = os.path.join(data_dir, rel)
        if not os.path.exists(path):
            print(f"MISSING {rel}")
            rc = 1
            continue
        got = _sha256(path)
        if got != want["sha256"]:
            print(f"CORRUPT {rel}: sha256 {got} != recorded {want['sha256']}")
            rc = 1
        else:
            print(f"OK {rel} ({want['bytes']} bytes)")
    return rc


def stats(dataset: str, data_dir: str, clients: int = 10) -> int:
    """Reference data/*/stats.py-style per-client summary through the
    registry loader (surrogate fallback applies, loudly, like every run)."""
    import numpy as np

    from fedml_tpu_torch.data.registry import load_dataset

    ds = load_dataset(dataset, client_num_in_total=clients, data_dir=data_dir)
    counts = np.asarray(ds.train.counts)
    ys = [np.asarray(ds.train.y[i][: counts[i]]).reshape(-1) for i in range(ds.client_num)]
    all_y = np.concatenate(ys) if ys else np.zeros(0, np.int64)
    print(f"dataset: {ds.name}")
    print(f"clients: {ds.client_num}")
    print(f"train samples: {int(counts.sum())}  test samples: {int(ds.test_global[0].shape[0])}")
    print(f"samples/client: mean {counts.mean():.1f}  std {counts.std():.1f}  "
          f"min {counts.min()}  max {counts.max()}")
    print(f"classes: {ds.class_num}")
    hist = np.bincount(all_y.astype(np.int64), minlength=ds.class_num)
    print("class histogram:", hist.tolist())
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m fedml_tpu_torch.data.acquire")
    sub = p.add_subparsers(dest="cmd", required=True)
    names = sorted(CATALOG)
    for cmd in ("fetch", "verify", "stats"):
        sp = sub.add_parser(cmd)
        sp.add_argument("dataset",
                        choices=names if cmd != "stats" else None)
        sp.add_argument("--data_dir", default="./data")
        if cmd == "fetch":
            sp.add_argument("--dry_run", action="store_true")
            sp.add_argument("--retries", type=int, default=None,
                            help="attempts per artifact (default 4, "
                                 "capped full-jitter backoff between)")
        if cmd == "stats":
            sp.add_argument("--clients", type=int, default=10)
    a = p.parse_args(argv)
    if a.cmd == "fetch":
        return fetch(a.dataset, a.data_dir, a.dry_run, retries=a.retries)
    if a.cmd == "verify":
        return verify(a.dataset, a.data_dir)
    return stats(a.dataset, a.data_dir, a.clients)


if __name__ == "__main__":
    raise SystemExit(main())
