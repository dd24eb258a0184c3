"""System utilities of the port (counterpart of viprs_tpu.utils.system and
the loader's ``get_filenames``): file-name expansion, directories, and the
stdlib logging set-up of the CLI. Standard library only."""

import glob as _glob
import logging
import os


def makedir(dirs):
    if isinstance(dirs, str):
        dirs = [dirs]
    for d in dirs:
        os.makedirs(d, exist_ok=True)


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
