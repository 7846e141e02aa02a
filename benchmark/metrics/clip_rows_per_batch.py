"""Host output: rows that ``cigars_nm_blob`` aligns again in clip mode
on the host (``MapResult.clipped``; both mates of a pair batch); the
mean over the window's untraced batches."""


def read(run):
    v = [m["clip_rows"] for m in run["batches"]]
    return sum(v) / len(v) if v else None
