from .qmix_learner import LEARNER_REGISTRY, LearnerState, QMixLearner

__all__ = ["LEARNER_REGISTRY", "LearnerState", "QMixLearner"]
