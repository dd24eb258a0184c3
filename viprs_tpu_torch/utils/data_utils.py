"""Data-download helpers (parity: viprs/utils/data_utils.py, which is itself a
NotImplemented stub in the reference)."""


def download_ld_matrix(*args, **kwargs):
    """Download pre-computed LD matrices (e.g. the UKB panels on Zenodo).

    Not implemented: this environment has no network egress. Download the
    stores externally and convert them with tools/convert_ld_store.py.
    """
    raise NotImplementedError(
        "Automatic LD matrix download is not available; fetch the store "
        "externally and convert it with tools/convert_ld_store.py.")
