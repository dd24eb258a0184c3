"""System utilities of the port (counterpart of viprs_tpu.utils.system and
the loader's ``get_filenames``): file-name expansion, directories, the
stdlib logging set-up of the CLI and a peak-memory sampler. Standard
library only (psutil is imported inside the calls that need it)."""

import glob as _glob
import logging
import os
import threading
import time


def is_numeric(x):
    try:
        float(x)
        return True
    except (TypeError, ValueError):
        return False


def makedir(dirs):
    if isinstance(dirs, str):
        dirs = [dirs]
    for d in dirs:
        os.makedirs(d, exist_ok=True)


def is_path_writable(path):
    """True if the (existing or to-be-created) path is writable."""
    target = path
    while target and not os.path.exists(target):
        target = os.path.dirname(target) or '.'
    return os.access(target or '.', os.W_OK)


def _expand_hf_path(path):
    """Resolve an ``hf://`` path or wildcard (the published LD panels'
    cloud form) to local files through ``huggingface_hub``, imported here
    only: matching remote files are fetched into the local HF cache and
    their local paths returned, so the readers see ordinary files."""
    try:
        from huggingface_hub import HfFileSystem, hf_hub_download
    except ImportError as e:
        raise ImportError(
            f"Reading {path} requires the `huggingface_hub` package "
            f"(python -m pip install huggingface_hub).") from e

    fs = HfFileSystem()
    remote = sorted(fs.glob(path.removeprefix('hf://')))
    if not remote:
        remote = [path.removeprefix('hf://')]
    local = []
    for r in remote:
        # hf paths look like datasets/<org>/<repo>/<file...>
        parts = r.split('/')
        if parts[0] in ('datasets', 'spaces'):
            repo_id, fname = '/'.join(parts[1:3]), '/'.join(parts[3:])
            repo_type = parts[0].rstrip('s')
        else:
            repo_id, fname = '/'.join(parts[:2]), '/'.join(parts[2:])
            repo_type = 'model'
        local.append(hf_hub_download(repo_id=repo_id, filename=fname,
                                     repo_type=repo_type))
    return local


def get_filenames(path_or_pattern):
    """Expand a path, a glob pattern or a list of them into a sorted file
    list (a pattern that matches nothing is returned as given, so the
    caller reports the missing file). ``hf://`` paths resolve through
    ``huggingface_hub``."""
    if path_or_pattern is None:
        return []
    if isinstance(path_or_pattern, (list, tuple)):
        out = []
        for p in path_or_pattern:
            out.extend(get_filenames(p))
        return out
    if str(path_or_pattern).startswith('hf://'):
        return _expand_hf_path(str(path_or_pattern))
    matches = sorted(_glob.glob(str(path_or_pattern)))
    return matches if matches else [str(path_or_pattern)]


def setup_logger(loggers=None, modules=None, log_file=None, log_format=None,
                 log_level='WARNING'):
    """Configure stdlib logging for the given logger names/modules."""
    level = getattr(logging, str(log_level).upper(), logging.WARNING)
    fmt = logging.Formatter(log_format or
                            '%(asctime)s - %(name)s - %(levelname)s - %(message)s')
    handlers = [logging.StreamHandler()]
    if log_file:
        makedir(os.path.dirname(log_file) or '.')
        handlers.append(logging.FileHandler(log_file))
    names = list(loggers or []) + list(modules or [])
    targets = [logging.getLogger(n) for n in names] or [logging.getLogger()]
    for lg in targets:
        lg.setLevel(level)
        for h in handlers:
            h.setFormatter(fmt)
            lg.addHandler(h)
    return targets


class PeakMemoryProfiler:
    """Context manager sampling the peak resident memory of the current
    process (MB) every ``interval`` seconds on a daemon thread."""

    def __init__(self, interval=0.2):
        self.interval = interval
        self.peak_mb = 0.0
        self._stop = None
        self._thread = None

    def _sample(self):
        import psutil
        proc = psutil.Process()
        while not self._stop.is_set():
            try:
                self.peak_mb = max(self.peak_mb,
                                   proc.memory_info().rss / 1024 ** 2)
            except Exception:
                pass
            time.sleep(self.interval)

    def _sample_once(self):
        try:
            import psutil
            self.peak_mb = max(self.peak_mb,
                               psutil.Process().memory_info().rss / 1024 ** 2)
        except Exception:
            pass

    def __enter__(self):
        self._stop = threading.Event()
        self._sample_once()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._sample_once()
        self._stop.set()
        self._thread.join(timeout=2.0)
        return False

    def get_peak_memory(self, unit='MB'):
        scale = {'MB': 1.0, 'GB': 1.0 / 1024}[unit]
        return self.peak_mb * scale
