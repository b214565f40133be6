"""Host seconds of the port's CSF builds and uploads in set-up
(``build_csf``, ``permute_modes`` where a cell builds several, and
``CSFArrays.from_csf``)."""


def read(run):
    return run.spans.get("csf_build_s")
