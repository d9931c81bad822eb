"""Scheduling time of a step: per window step, its ``sched.plan`` span
(the scheduler's plan, the data plane's drain, the plan's rejections,
resumes and preemptions), the mean, in ms (serving/scheduler)."""
from bench.common import spans


def read(run):
    plan = [sum(spans.ms(s) for s in inside if s.name == "sched.plan")
            for _, inside in spans.window_steps(run)]
    return sum(plan) / len(plan) if plan else None
