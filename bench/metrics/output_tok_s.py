"""output_tok_s: output tokens the window's steps gave, over the window's
seconds (its first step's start to its last step's end)."""


def read(run):
    if run.rec.window_s <= 0:
        return None
    return sum(run.rec.step_outputs) / run.rec.window_s
