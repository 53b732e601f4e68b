"""Mean f64 endgame iterations per instance of a cold batch (the
program's `n_iter_ds` counter; 0 for polish-accepted instances)."""


def read(rec: dict, name: str):
    return rec.get("endgame_iters")
