"""Trainer layer: the tuner's own re-plan seconds
(``StragglerTuner.last_replan_seconds`` after each attempt) summed over the
unprofiled steps of a traced window, per step, in ms; 0 where no attempt
fell there."""


def read(r):
    v = r.values
    if not v.get("tuner_steps"):
        return None
    return 1e3 * v["tuner_seconds"] / v["tuner_steps"]
