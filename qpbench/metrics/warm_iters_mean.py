"""Mean ADMM iterations of the warm-started replay steps (every step
but each stream's first): the program's own `n_iter` counter."""


def read(rec: dict, name: str):
    return rec.get("warm_iters")
